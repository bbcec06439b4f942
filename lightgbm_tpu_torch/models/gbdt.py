"""Gradient-boosting orchestration.

Counterpart of lightgbm_tpu/models/gbdt.py for the main path: single
device, serial tree learner, K trees an iteration (K = num_class for the
multiclass objectives, else 1), grown by the strict grower
(ops/treegrow.py::grow_tree: tree_growth_mode=strict, or auto when training
on the CPU), the round-batched grower (ops/treegrow_fast.py: rounds, or auto
on the card), or the windowed grower (ops/treegrow_windowed.py) in the wide
regime on the card (``_use_windowed``).  Reference: src/boosting/gbdt.cpp
(GBDT::{Init,TrainOneIter}), gbdt_model_text.cpp (the `.txt` model).

Each iteration is an ordinary Python step on device tensors: gradients,
tree growth, and the score update `score += leaf_value[leaf_id] *
shrinkage`, which is a gather because the grower keeps every row's leaf id.
Trees stay device TreeArrays until something needs host trees
(save/predict), as in the JAX package.

``fused_training`` (default true) is honoured as the JAX package's
one-dispatch contracts: every windowed round, and every round of the rounds
grower where ``_fused_eligible`` holds, runs through one ops/graphs.py
cache a training, one CUDA-graph replay a round on the card (on the CPU the
same round functions run eagerly on the same static buffers).  Gradients,
the root pass, the tree's finalize and the score update stay eager around
the replays.  With fused_training=false every round is eager torch
launches.  Nothing falls back from one to the other.  Whether training can
go on is read from the device every 32 iterations on the rounds and
windowed growers, as the JAX package does on its rounds path, and every
iteration on the strict grower, as its strict path does: one blocking read
an iteration there, none inside a tree.

Objectives that renew leaf outputs (L1, quantile, MAPE) renew each tree
after growth, on any grower (the JAX package's renew hook after the tree).

The boosting modes are the JAX package's: GOSS (``goss_mask``, a sampling
strategy of GBDT), DART (``DART``: dropped trees leave the score and come
back rescaled) and random forest (``RF``: gradients at the init score,
averaged output), built by ``create_boosting``.  Trees not yet read by the
host stay device TreeArrays with the list of factors that scale them
(``_pending``); the score arithmetic of DART, rollback and a late
validation set reads their leaf values and leaf ids on the device
(``_tree_leaf_values``, ``_tree_leaves``), so none of them drains the
device queue.

Categorical features (the Dataset's categorical mask), feature_contri and
hist_precision=bf16 reach every grower, as in the JAX package; a model
with categorical splits predicts through the stacked walk's bitsets.  A
Dataset's EFB plan (basic.py, io/efb.py) reaches the rounds and windowed
growers, whose histogram passes read the bundled matrix; their leaf tile
comes from the bundled column count F_b, as the JAX package's _leaf_tile
does.  The strict grower histograms the features, as the JAX package's
does.

The constraint envelope is the JAX package's too: monotone constraints
(basic, intermediate; advanced runs as intermediate, with its warning) and
monotone_penalty, interaction constraints, forced splits
(forcedsplits_filename, a (leaf, feature, bin) schedule), CEGB split,
coupled and lazy penalties, extra_trees and feature_fraction_bynode, and
linear trees (ops/linear.py, fitted and predicted on the training device
from the Dataset's raw values).  The per-node draws are a per-tree table of
uniforms (``_node_uniforms``), not the JAX package's threefry keys.  The
gates are the JAX package's: the windowed grower takes none of these
options but per-node sampling, and the fused (graph) rounds take none of
CEGB coupled or lazy penalties, per-node sampling or linear trees.

Distributed (tree_learner=data, voting or feature over more than one
torch.distributed rank, parallel/): the rank's rows (or feature block)
through parallel/data_parallel.py and feature_parallel.py; the init score,
the pre-filter, GOSS, leaf renewal and the metrics over every rank's rows
(gathered in the serial order), bagging a slice of the serial draw, so a
data-parallel training is the serial one; the rounds eager.  With the
windowed grower, tree_learner=feature2d with num_feature_shards > 1 trains
over a 2-D (data, feature) mesh (parallel/feature2d.py: the serial tree
bit for bit) and num_slices > 1 with tree_learner=data or voting over a
hierarchical (dcn, ici) mesh (parallel/hierarchy.py); a shard or slice
count that does not divide the world warns and trains on the single-level
mesh, as in the JAX package.
"""

from __future__ import annotations

import copy
import json
import re
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..obs import metrics as _obs
from ..obs import trace as _trace
from ..metrics import Metric, create_metrics
from ..objectives import Objective, create_objective
from ..ops import predict as predict_ops
from ..ops.hist_cuda import recommended_leaf_tile
from ..ops.graphs import RoundGraphs
from ..ops.linear import fit_linear_leaves, predict_linear_rows
from ..ops.split import SplitParams
from ..ops.treegrow import grow_tree
from ..ops.treegrow_fast import grow_tree_fast, predict_leaf_arrays
from ..ops.treegrow_ooc import grow_tree_ooc
from ..ops.treegrow_windowed import grow_tree_windowed
from ..parallel import collectives as _coll
from ..parallel import data_parallel as _dpar
from ..parallel import feature2d as _f2d
from ..parallel import feature_parallel as _fpar
from ..parallel import hierarchy as _hier
from ..parallel.distributed import init_distributed
from ..parallel.feature2d import Sharded2DData
from ..parallel.hierarchy import SlicedData
from ..parallel.mesh import (DATA_AXIS, current_mesh, make_mesh_2d,
                             make_mesh_hierarchical)
from ..utils import faults as _faults
from ..utils import locktrace as _lt
from ..utils import profiling as _profiling  # noqa: F401  (LGBMTPU_NVTX=1 bridge)
from ..utils import sanitizer as _san
from ..utils.guards import NonFiniteError
from ..utils.log import log_warning
from .tree import Tree, tree_from_device, tree_to_if_else

_MODEL_VERSION = "v4"

# the prediction bucket ladder: a batch of n rows takes the rung of the
# next power of two (at least 8).  The JAX package pads to the rung so its
# traversal compiles once a rung; here the rung keys the model's pinned
# host buffers and the latency reservoirs, and the traversal runs on the
# n rows themselves
_PREDICT_BUCKET_MIN = 8
# a pinned buffer is kept only up to this size: a larger rung stages its
# rows through two pinned chunk buffers of at most this size in turns, and
# reads through pageable memory
_PINNED_MAX_BYTES = 32 << 20
# guards the lazy creation of a GBDT's pack lock
_PACK_LOCK_INIT = threading.Lock()


def _predict_bucket(n: int) -> int:
    """The rung of a batch of n rows."""
    b = _PREDICT_BUCKET_MIN
    while b < n:
        b <<= 1
    return b


class _PinnedBuffers:
    """A model's pinned host buffers for prediction, one a (shape, dtype),
    allocated at first use and shared by all its packs, so a version bump
    allocates nothing again.  ``lock`` is held from a call's staging to its
    read, which also retires an upload before its buffer is written again."""

    __slots__ = ("lock", "bufs")

    def __init__(self):
        self.lock = threading.Lock()
        self.bufs: Dict[tuple, torch.Tensor] = {}

    def get(self, shape: tuple, dtype: torch.dtype,
            slot: int = 0) -> Tuple[Optional[torch.Tensor], bool]:
        """(buffer, allocated by this call); (None, False) when the buffer
        would hold more than _PINNED_MAX_BYTES.  ``slot`` tells apart the
        chunk buffers of one shape."""
        key = (shape, dtype, slot)
        buf = self.bufs.get(key)
        if buf is not None:
            return buf, False
        if int(np.prod(shape)) * dtype.itemsize > _PINNED_MAX_BYTES:
            return None, False
        buf = self.bufs[key] = torch.empty(shape, dtype=dtype, pin_memory=True)
        return buf, True

    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.bufs.values())


def resolve_device(cfg: Config) -> torch.device:
    """device_type -> torch.device.  The card is the default; without one,
    training raises instead of carrying on quietly on the CPU."""
    if cfg.device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device_type={cfg.device_type!r} but torch.cuda.is_available() is "
            "False: no CUDA card here.  Pass device_type='cpu' to train on "
            "the host.")
    return torch.device("cuda", torch.cuda.current_device())


def _f32_threshold_upper(t: np.ndarray) -> np.ndarray:
    """Round f64 thresholds UP to f32 so the f32 traversal keeps
    `v <= t (f64)  =>  f32(v) <= t32` (rows left of the split stay left)."""
    t = np.asarray(t, np.float64)
    t32 = t.astype(np.float32)
    bump = t32.astype(np.float64) < t
    return np.where(bump, np.nextafter(t32, np.float32(np.inf)), t32)


_TREE_LEARNERS = ("serial", "data", "voting", "feature", "feature2d")


def _parse_interaction_constraints(spec, feature_names) -> List[List[int]]:
    """interaction_constraints as lists of feature indices: the string form
    "[0,1,2],[2,3]" or lists of indices or names (the JAX package's
    parser; reference: config interaction_constraints)."""
    if not spec:
        return []
    if isinstance(spec, str):
        sets = [[t.strip() for t in g.split(",") if t.strip()]
                for g in re.findall(r"\[([^\]]*)\]", spec)]
    else:
        sets = [list(g) for g in spec]
    name_to_idx = {nm: i for i, nm in enumerate(feature_names or [])}
    out = []
    for g in sets:
        idxs = []
        for it in g:
            if isinstance(it, str) and not it.lstrip("-").isdigit():
                if it in name_to_idx:
                    idxs.append(name_to_idx[it])
            else:
                idxs.append(int(it))
        out.append(idxs)
    return out


def _scaled_penalties(values, f: int, tradeoff: float) -> Optional[np.ndarray]:
    """A CEGB per-feature penalty list as an (F,) f32 vector pre-scaled by
    cegb_tradeoff, or None when every penalty is 0."""
    values = list(values or [])
    if not any(v != 0 for v in values):
        return None
    pen = np.zeros(f, np.float32)
    for i, v in enumerate(values[:f]):
        pen[i] = tradeoff * float(v)
    return pen


def goss_mask(g: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
              top_rate: float, other_rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """GOSS row selection (reference: goss.hpp; the JAX package's
    _goss_mask): keep the top ``top_rate`` of the rows by |g * h| (summed
    over classes), draw ``other_rate`` of the rest from the uniforms ``u``
    and weight the drawn rows by (1 - top_rate) / other_rate.  Returns
    (mask bool, weights f32), computed on the device: the threshold is an
    element of the sorted scores, read by a view, not by the host."""
    score_abs = (g * h).abs()
    if score_abs.dim() > 1:
        score_abs = score_abs.sum(dim=1)
    n = score_abs.shape[0]
    top_k = max(int(n * top_rate), 1)
    other_k = max(int(n * other_rate), 1)
    thresh = torch.sort(score_abs).values[n - top_k]
    top = score_abs >= thresh
    # f32 of the quotient, as the JAX package's f32 division gives it
    rest = ~top & (u < float(np.float32(other_k / max(n - top_k, 1))))
    amp = float(np.float32((1.0 - top_rate) / other_rate))
    return top | rest, torch.ones_like(u, dtype=torch.float32).masked_fill(rest, amp)


def _hist_columns(ts) -> int:
    """Columns the rounds and windowed growers' histogram passes read: the
    bundled ones (F_b) with an EFB plan, else the features."""
    return ts.efb.num_bundled if ts.efb is not None else ts.num_feature()


def tree_depth(tree: Tree) -> int:
    """Levels of a host tree: internal nodes on its longest root-leaf path."""
    if tree.num_internal == 0:
        return 0
    depth, frontier = 0, [0]
    while frontier:
        depth += 1
        frontier = [int(c) for nd in frontier
                    for c in (tree.left_child[nd], tree.right_child[nd]) if c >= 0]
    return depth


def _dummy_tree() -> Tree:
    """A one-leaf tree of value 0: pads the trees of an early-stop
    prediction to a whole number of windows."""
    z32 = np.zeros(0, np.int32)
    return Tree(num_leaves=1, split_feature=z32, threshold=np.zeros(0, np.float64),
                threshold_bin=None, decision_type=np.zeros(0, np.uint8),
                split_gain=np.zeros(0, np.float32), left_child=z32, right_child=z32,
                internal_value=np.zeros(0, np.float64),
                internal_weight=np.zeros(0, np.float64),
                internal_count=np.zeros(0, np.int64), leaf_value=np.zeros(1, np.float64),
                leaf_weight=np.zeros(1, np.float64), leaf_count=np.zeros(1, np.int64))


class GBDT:
    """reference: class GBDT in src/boosting/gbdt.h."""

    average_output = False  # random forest: predictions average the trees

    def __init__(self, cfg: Config, train_set=None):
        self.cfg = cfg
        self.objective: Optional[Objective] = create_objective(cfg)
        self.train_set = None
        self._models: List[Tree] = []  # host trees
        # trees after _models, not yet read by the host: [device TreeArrays,
        # [factors], linear fit or None], the factors applied in order when
        # the host tree is made (shrinkage, then any DART rescales), as
        # Tree.apply_shrinkage applies them to a host tree; a linear tree's
        # fit is (coef, const, feat_idx, nfeat) from ops/linear.py
        self._pending: List[list] = []
        # this iteration's gradients (GOSS reads them)
        self._cur_grad = self._cur_hess = None
        self.iter_ = 0
        self.num_tree_per_iteration = cfg.num_tree_per_iteration
        self.init_scores = [0.0] * self.num_tree_per_iteration
        self.feature_names: List[str] = []
        self.metrics: List[Metric] = []
        self.train_name = "training"
        self.valid_sets: List = []
        self.valid_names: List[str] = []
        self._valid_scores: List[torch.Tensor] = []
        self.binner = None
        self._last_mask = None
        self._nobag = None
        # trees dropped in each DART iteration (DART fills it)
        self.drops: List[int] = []
        self.device = torch.device("cpu")
        # per-tree round-driver stats of both growers (grower, rounds,
        # host_syncs, async_resolves, captures, replays, dispatches, retries,
        # windows; the windowed grower's megakernel and megakernel_excluded)
        self.round_stats: List[dict] = []
        # the captured rounds of this training (fused_training)
        self._round_graphs: Optional[RoundGraphs] = None
        self._round_graphs_shape: Optional[tuple] = None
        # first iteration (1-based) whose trees carried a non-finite leaf
        # value or split gain, 0 while clean: kept on the device and read
        # with the finish check (the JAX package's guard rail)
        self._guard_bad_iter = None
        # the training's categorical features and feature_contri (None when
        # it has none)
        self._categorical_mask: Optional[torch.Tensor] = None
        self._feature_contri: Optional[torch.Tensor] = None
        # the constraint envelope of the training (reset_training_data)
        self._monotone: Optional[torch.Tensor] = None
        self._interaction_sets: Optional[torch.Tensor] = None
        self._needs_node_rng = False
        self._cegb_coupled = self._cegb_used_global = None
        self._cegb_lazy = self._cegb_lazy_used = None
        self._forced_cache = None
        self._linear = False
        self._ooc_spill = False  # the out-of-core spill regime
        # the distributed tree learner (tree_learner=data|voting|feature|
        # feature2d over more than one rank): this rank's rows (data, voting;
        # under feature2d its row block, over the data axis) or feature
        # block (feature); the 2-D tile and the hierarchical layout beside
        # them; None for a serial training
        self._dp: Optional[_dpar.ShardedData] = None
        self._fp: Optional[_fpar.FeatureShardedData] = None
        self._dp2d = None
        self._dp_hier = None
        # the packed-ensemble cache of prediction (``_packed``): entries
        # keyed by (version, tree range, ...); every mutation bumps the
        # version (``_invalidate_pred_cache``) under the pack lock
        self._pred_cache = None
        self._pack_version = 0
        self._pack_lock = _lt.rlock("gbdt.pack")
        self._pinned = _PinnedBuffers()
        # telemetry is process-wide and on by default; an explicit
        # telemetry= applies for this model's lifetime (the JAX package's)
        _obs.set_enabled(bool(cfg.telemetry) if cfg.is_set("telemetry")
                         else _obs.DEFAULT_ENABLED)
        if train_set is not None:
            self.reset_training_data(train_set)

    # ------------------------------------------------------------------
    @property
    def models(self) -> List[Tree]:
        """Host trees; converts pending device trees first."""
        if self._pending:
            pending, self._pending = self._pending, []
            for arrays, factors, linear in pending:
                tree = tree_from_device(
                    arrays.to_numpy(), self.binner,
                    linear=None if linear is None else [a.cpu().numpy() for a in linear])
                for f in factors:
                    tree.apply_shrinkage(f)
                self._models.append(tree)
        return self._models

    @models.setter
    def models(self, value) -> None:
        self._pending = []
        self._models = value
        self._invalidate_pred_cache("models_setter")

    def __getstate__(self):
        # locks and pinned buffers cannot be pickled or deep-copied: the
        # pack lock, the pack cache and the pinned buffers are made again
        d = dict(self.__dict__)
        d.pop("_pack_lock", None)
        d.pop("_pinned", None)
        d["_pred_cache"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._pinned = _PinnedBuffers()
        self._plock()

    def _plock(self):
        """The pack lock, created once for an unpickled or copied model
        (``__setstate__``) under a module lock, so racing callers share
        one."""
        lock = getattr(self, "_pack_lock", None)
        if lock is None:
            with _PACK_LOCK_INIT:
                if getattr(self, "_pack_lock", None) is None:
                    self._pack_lock = _lt.rlock("gbdt.pack")
                lock = self._pack_lock
        return lock

    def _invalidate_pred_cache(self, reason: str) -> None:
        """Bump the pack version instead of emptying the cache (the JAX
        package's): the next prediction packs the ensemble anew under the
        new version, while the packs of the previous version stay in the
        cache for requests in flight.  Older versions than
        _PACKED_KEEP_VERSIONS are evicted here.  Called at every mutation
        of the trees: a tree appended (pending or host), a rollback, the
        ``models`` setter, a DART rescale, refit, shuffle_models and
        set_leaf_output.  The bump and the eviction hold the pack lock
        that ``_packed``'s lookup holds."""
        with self._plock():
            cache = self._pred_cache
            if cache:
                _obs.counter("predict_cache_invalidations_total").inc()
                _obs.event("pred_cache_invalidate", reason=reason,
                           version=self._pack_version + 1)
            self._pack_version += 1
            if cache:
                floor = self._pack_version - self._PACKED_KEEP_VERSIONS
                stale = [key for key in cache if key[0] <= floor]
                for key in stale:
                    del cache[key]
                if stale:
                    _obs.counter("predict_stale_pack_evictions_total").inc(len(stale))

    # -- the ensemble's trees on the device, without reading pending trees
    def _num_trees(self) -> int:
        return len(self._models) + len(self._pending)

    def _tree_leaf_values(self, i: int) -> torch.Tensor:
        """Tree i's leaf values as the score adds them back (f32 of the host
        tree's f64 values), on the device; a pending tree's are its device
        values times its factors in f64, so no host read."""
        if i < len(self._models):
            return torch.as_tensor(np.asarray(self._models[i].leaf_value, np.float32),
                                   device=self.device)
        arrays, factors, _ = self._pending[i - len(self._models)]
        return _scaled(arrays.leaf_value, factors)

    def _tree_linear(self, i: int) -> Optional[tuple]:
        """Tree i's linear leaf models on the device as
        predict_linear_rows takes them (coef, const, feat_idx, nfeat, leaf
        value), scaled like its leaf values; None for a constant tree."""
        if i < len(self._models):
            return _linear_tables(self._models[i], self.device)
        arrays, factors, linear = self._pending[i - len(self._models)]
        if linear is None:
            return None
        coef, const, fidx, nf = linear
        return (_scaled(coef, factors), _scaled(const, factors), fidx, nf,
                _scaled(arrays.leaf_value, factors))

    def _tree_leaves(self, i: int, ds) -> torch.Tensor:
        """Tree i's leaf id for each row of the constructed dataset ``ds``,
        on the device (the JAX package's Dataset.predict_leaf_binned_tree)."""
        if i < len(self._models):
            return ds.predict_leaf_binned_tree(self._models[i])
        arrays = self._pending[i - len(self._models)][0]
        return ds.over_rows(lambda bins: predict_leaf_arrays(
            arrays, bins, ds.missing_bin_pf_device,
            categorical=self._categorical_mask is not None))

    def _tree_rows(self, i: int, ds) -> torch.Tensor:
        """(N,) f32: tree i's value for each row of ``ds`` (a linear tree's
        from the set's raw values)."""
        leaves = self._tree_leaves(i, ds).long()
        linear = self._tree_linear(i)
        if linear is None:
            return self._tree_leaf_values(i)[leaves]
        if getattr(ds, "raw_device", None) is None:
            raise ValueError("a linear tree needs the raw feature values of the "
                             "Dataset: construct it with linear_tree in its params")
        return predict_linear_rows(ds.raw_device, leaves, *linear)

    def _scale_tree(self, i: int, factor: float) -> None:
        """Tree::Shrinkage on tree i, pending or not."""
        if i < len(self._models):
            self._models[i].apply_shrinkage(factor)
        else:
            self._pending[i - len(self._models)][1].append(factor)
        self._invalidate_pred_cache("scale_tree")

    def _scored_sets(self) -> List[tuple]:
        """(dataset, score) of the training set and every validation set."""
        return [(self.train_set, self._score)] + list(zip(self.valid_sets,
                                                          self._valid_scores))

    # ------------------------------------------------------------------
    def reset_training_data(self, train_set) -> None:
        """reference: GBDT::ResetTrainingData.

        Not carried over from the JAX package: its wide-data int8 default
        (``_quantized_wide_default``, which switches a training with >= 256
        features, max_bin > 64 and the rounds grower to int8 gradients with
        leaf renewal on its device).  On the H100, float is the faster
        choice at that shape: the Epsilon-shaped cell (400k x 2000, 255
        bins, 255 leaves) trains at 17.4-17.7 iterations/s in float against
        4.0-4.2 in int8 (chip_smoke.py, PERF.md section 5).  So the port
        trains float unless use_quantized_grad is set."""
        cfg = self.cfg
        if cfg.tree_learner not in _TREE_LEARNERS:
            raise ValueError(f"tree_learner must be one of {_TREE_LEARNERS}, got "
                             f"{cfg.tree_learner!r}")
        if cfg.num_machines > 1:
            # multi-process bring-up (reference: Network::Init from the
            # machine list), before the Dataset puts anything on a device:
            # the rank picks its card here
            init_distributed(cfg)
        self.device = dev = resolve_device(cfg)
        self.train_set = train_set
        self._round_graphs = None
        train_set.construct(device=dev)
        self.binner = train_set.binner
        self.feature_names = list(train_set.feature_names)
        self.metrics = create_metrics(cfg)
        n = train_set.num_data()
        k = self.num_tree_per_iteration
        shape = (n,) if k == 1 else (n, k)
        self._label = torch.as_tensor(train_set.label, dtype=torch.float32,
                                      device=dev)
        self._weight = (None if train_set.weight is None else torch.as_tensor(
            train_set.weight, dtype=torch.float32, device=dev))
        init = torch.zeros(shape, dtype=torch.float32, device=dev)
        obj = self.objective
        self._set_learner(train_set)
        if obj is not None:
            obj.prepare(np.asarray(train_set.label), train_set.weight)
            if cfg.boost_from_average and not self.models:
                # data and voting ranks hold their rows only: the init score
                # is the serial one, from every rank's labels (reference:
                # BoostFromScore syncing through Network::GlobalSyncUpBySum;
                # the JAX package all-gathers them too)
                label_all, weight_all = self._label, self._weight
                if self._dp is not None:
                    label_all = _coll.all_gather_ragged(self._label, self._dp.mesh)
                    if self._weight is not None:
                        weight_all = _coll.all_gather_ragged(self._weight,
                                                             self._dp.mesh)
                if k == 1:
                    self.init_scores = [obj.boost_from_score(label_all, weight_all)]
                    init += np.float32(self.init_scores[0])
                else:
                    lbl, wt = np.asarray(train_set.label), train_set.weight
                    if self._dp is not None:
                        mesh = self._dp.mesh
                        lbl = _coll.all_gather_ragged(torch.as_tensor(
                            lbl, dtype=torch.float64, device=dev), mesh).cpu().numpy()
                        if wt is not None:
                            wt = _coll.all_gather_ragged(torch.as_tensor(
                                np.asarray(wt, np.float64), device=dev),
                                mesh).cpu().numpy()
                    self.init_scores = _class_init_scores(lbl, wt, k)
                    init += torch.as_tensor(np.asarray(self.init_scores, np.float32),
                                            device=dev)[None, :]
        if train_set.init_score is not None:
            init += torch.as_tensor(np.asarray(train_set.init_score, np.float32)
                                    .reshape(shape), device=dev)
        self._score = init
        if obj is not None and hasattr(obj, "set_query"):
            qb = train_set.query_boundaries
            if qb is None:
                raise ValueError(f"objective={obj.name} needs query information: "
                                 "pass Dataset(group=...)")
            width = 0
            if self._dp is not None:  # every rank pads to the serial width (C20)
                longest = torch.tensor([int(np.diff(qb).max()) if len(qb) > 1 else 0],
                                       dtype=torch.int64, device=dev)
                width = int(_coll.pmax(longest, self._dp.mesh).cpu()[0])
            obj.set_query(qb, np.asarray(train_set.label), dev, width)
            if hasattr(obj, "set_positions") and train_set.position is not None:
                obj.set_positions(train_set.position)
        self._guard_bad_iter = torch.zeros((), dtype=torch.int32, device=dev)
        self.reset_split_params()
        allowed = np.ones(train_set.num_feature(), dtype=bool)
        if cfg.feature_pre_filter and cfg.min_data_in_leaf > 1:
            allowed = (train_set.pre_filter_mask(int(cfg.min_data_in_leaf))
                       if self._dp is None else self._global_pre_filter(train_set))
        self._allowed_np = allowed
        self._allowed_features = torch.as_tensor(allowed, device=dev)
        # None without categorical features, so the growers skip the
        # categorical candidates (as the JAX package passes None)
        cat_mask = np.asarray(train_set.binner.categorical_mask)
        self._categorical_mask = (torch.as_tensor(cat_mask, device=dev)
                                  if cat_mask.any() else None)
        # per-feature split-gain multipliers (reference: config
        # feature_contri), padded with 1.0 to every feature
        fc = list(cfg.feature_contri or [])
        f = train_set.num_feature()
        self._feature_contri = (
            torch.as_tensor(np.asarray((fc + [1.0] * f)[:f], np.float32), device=dev)
            if any(float(c) != 1.0 for c in fc) else None)
        self._check_spill_envelope(train_set)
        self._leaf_tile = recommended_leaf_tile(
            train_set.max_num_bins,
            (_hist_columns(train_set) if self._dp is None
             else train_set.num_feature()), cfg.num_leaves,
            quantized=bool(cfg.use_quantized_grad),
            hist_precision=cfg.hist_precision)
        self._set_envelope(train_set)
        if self._dp is not None or self._fp is not None:
            self._warn_distributed()

    def _set_learner(self, ts) -> None:
        """The distributed tree learner (the JAX package's learner set-up,
        with the world size standing where it has the device count): over
        more than one rank, tree_learner=data and voting shard the rows
        (each rank's Dataset holds its rows: pre_partition), feature the
        features (each rank holds all rows).  tree_learner=feature2d with
        num_feature_shards d_f > 1 lays the world out as a (R / d_f, d_f)
        (data, feature) mesh: the rank at (i, j) holds row block i (its
        Dataset) and keeps feature block j of it; ``_dp`` is its rows over
        the data axis, which every other learner path and the set-up read
        (so the full-F rows stay resident beside the tile: ROADMAP A13c).
        num_slices > 1 (data, voting) adds the hierarchical layout of the
        same rows.  A count that does not divide the world warns and
        trains on the single-level mesh, as in the JAX package.  At world
        size 1 they train serially, as the JAX package's do on one
        device."""
        self._dp = self._fp = self._dp2d = self._dp_hier = None
        if self.cfg.tree_learner == "serial":
            return
        mesh = current_mesh()
        if mesh is None:
            return
        if getattr(ts, "ooc_spill", False):
            raise ValueError("out_of_core spill training is serial: "
                             f"tree_learner={self.cfg.tree_learner} over "
                             f"{mesh.size} ranks needs the rows resident")
        nbpf = ts.num_bins_pf_device
        mbpf = ts.missing_bin_pf_device
        if self.cfg.tree_learner == "feature":
            self._fp = _fpar.FeatureShardedData(mesh, ts.bins_device, nbpf, mbpf)
            return
        if self.cfg.tree_learner == "feature2d":
            d_f = max(int(self.cfg.num_feature_shards), 1)
            if d_f > 1 and mesh.size % d_f:
                log_warning(f"num_feature_shards={d_f} does not divide {mesh.size} "
                            "ranks; training on the single-level row mesh")
                d_f = 1
            if d_f > 1:
                grid = make_mesh_2d(mesh.size // d_f, d_f)
                self._dp2d = Sharded2DData(grid, ts.bins_device, nbpf, mbpf)
                self._dp = _dpar.ShardedData(grid.axes[DATA_AXIS], ts.bins_device,
                                             nbpf, mbpf)
                return
        self._dp = _dpar.ShardedData(mesh, ts.bins_device, nbpf, mbpf)
        ns = int(self.cfg.num_slices)
        if ns > 1 and self.cfg.tree_learner in ("data", "voting"):
            if mesh.size % ns:
                log_warning(f"num_slices={ns} does not divide {mesh.size} ranks; "
                            "training on the single-level mesh")
            else:
                self._dp_hier = SlicedData.from_sharded(make_mesh_hierarchical(ns),
                                                        self._dp)

    def _global_pre_filter(self, ts) -> np.ndarray:
        """feature_pre_filter on every rank's bin counts (one psum), so
        every rank keeps the features the serial run keeps."""
        nbpf = np.asarray(ts.binner.num_bins_per_feature)
        width = max(int(nbpf.max()), 1)
        bins = ts.bins_device.long()
        f = bins.shape[1]
        counts = torch.zeros((f, width), dtype=torch.int64, device=bins.device)
        counts.scatter_add_(1, bins.T.clamp_max(width - 1),
                            torch.ones_like(bins.T))
        counts = _coll.psum(counts, self._dp.mesh).cpu().numpy()
        return _pre_filter(None, ts.binner, int(self.cfg.min_data_in_leaf),
                           counts=[counts[j, :max(int(nbpf[j]), 1)].copy()
                                   for j in range(f)],
                           n_rows=self._dp.shard.num_data)

    def _warn_distributed(self) -> None:
        """What the distributed learners do not carry (the JAX package's
        warnings), and what they refuse."""
        cfg = self.cfg
        if cfg.forcedsplits_filename:
            log_warning("forcedsplits_filename is not applied by the distributed "
                        "tree learners (tree_learner=data/feature/voting over "
                        "several ranks); use tree_learner=serial to force splits.")
        if self._cegb_lazy is not None:
            log_warning("cegb_penalty_feature_lazy is applied by the single-"
                        "device growers only (strict or rounds); this "
                        "distributed configuration IGNORES it.")
            self._cegb_lazy = self._cegb_lazy_used = None
        if self._linear:
            raise ValueError("linear_tree is implemented for the serial tree "
                             "learner only (its leaf fits sum over every rank's "
                             "rows)")

    def _check_spill_envelope(self, ts) -> None:
        """The out-of-core spill regime (the Dataset's rows exceed
        max_rows_in_hbm): training takes the chunk-streamed grower
        (ops/treegrow_ooc.py), whose envelope is the strict grower's core;
        an option outside it raises here, as in the JAX package, rather
        than train something else."""
        cfg = self.cfg
        self._ooc_spill = bool(getattr(ts, "ooc_spill", False))
        if not self._ooc_spill:
            return
        blocked = {
            "monotone_constraints": any(int(c) != 0 for c in cfg.monotone_constraints or []),
            "interaction_constraints": bool(cfg.interaction_constraints),
            "forcedsplits_filename": bool(cfg.forcedsplits_filename),
            "cegb penalties": any(p != 0 for p in (cfg.cegb_penalty_feature_coupled or [])
                                  + (cfg.cegb_penalty_feature_lazy or [])),
            "linear_tree": bool(cfg.linear_tree),
            "extra_trees / feature_fraction_bynode": bool(
                cfg.extra_trees or cfg.feature_fraction_bynode < 1.0),
            "boosting = dart": cfg.boosting == "dart",
        }
        bad = [k for k, v in blocked.items() if v]
        if bad:
            raise ValueError(
                "out_of_core spill training (rows > max_rows_in_hbm) does not "
                f"support: {', '.join(bad)}; raise max_rows_in_hbm (the resident "
                "regime trains everything) or drop the option (ops/treegrow_ooc.py)")
        if cfg.use_quantized_grad:
            log_warning("use_quantized_grad is ignored by the out-of-core spill "
                        "grower: it trains float (a mirror of the strict grower)")

    def _set_envelope(self, ts) -> None:
        """The constraint options as the growers take them (the JAX
        package's GBDT setup): the monotone vector, the interaction sets,
        the CEGB vectors (pre-scaled by cegb_tradeoff; the coupled "used"
        state carried across trees and classes, the lazy (N, F) charges
        returned by each tree), and the linear-tree gate."""
        cfg, dev = self.cfg, self.device
        f = ts.num_feature()
        mc = list(cfg.monotone_constraints or [])
        self._monotone = (
            torch.as_tensor(np.asarray((mc + [0] * f)[:f], np.int32), device=dev)
            if any(int(c) != 0 for c in mc) else None)
        sets = _parse_interaction_constraints(cfg.interaction_constraints,
                                              self.feature_names)
        mat = np.zeros((len(sets), f), dtype=bool)
        for i, st in enumerate(sets):
            mat[i, [j for j in st if 0 <= j < f]] = True
        self._interaction_sets = torch.as_tensor(mat, device=dev) if sets else None
        self._needs_node_rng = bool(cfg.extra_trees or cfg.feature_fraction_bynode < 1.0)
        coupled = _scaled_penalties(cfg.cegb_penalty_feature_coupled, f,
                                    cfg.cegb_tradeoff)
        self._cegb_coupled = (None if coupled is None
                              else torch.as_tensor(coupled, device=dev))
        self._cegb_used_global = (None if coupled is None
                                  else torch.zeros(f, dtype=torch.bool, device=dev))
        lazy = _scaled_penalties(cfg.cegb_penalty_feature_lazy, f, cfg.cegb_tradeoff)
        self._cegb_lazy = None if lazy is None else torch.as_tensor(lazy, device=dev)
        self._cegb_lazy_used = (None if lazy is None else torch.zeros(
            (ts.num_data(), f), dtype=torch.bool, device=dev))
        self._forced_cache = None
        if self._monotone is not None:
            method = cfg.monotone_constraints_method
            if method == "advanced":
                log_warning("monotone_constraints_method='advanced' is not "
                            "implemented; using 'intermediate'")
            if (method in ("intermediate", "advanced") and cfg.use_quantized_grad
                    and cfg.quant_train_renew_leaf):
                log_warning(
                    "quant_train_renew_leaf is skipped under intermediate "
                    "monotone bounds: renewed leaf values cannot be re-clipped "
                    "to evolving bounds without crossing a monotone split; leaf "
                    "values keep their creation-time (clipped, quantized) outputs.")
        self._linear = bool(cfg.linear_tree)
        if self._linear:
            if cfg.boosting == "dart":
                raise ValueError("linear_tree is not supported with boosting=dart "
                                 "(its drops and rescales assume constant leaves)")
            if self.objective is not None and self.objective.need_renew:
                # reference: Config::CheckParamConflict
                raise ValueError(f"linear_tree is not supported with objective="
                                 f"{self.objective.name} (leaf-output renewal)")
            if getattr(ts, "raw_device", None) is None:
                raise ValueError(
                    "linear_tree requires raw feature values: the Dataset was "
                    "constructed without linear_tree in its params (or raw data "
                    "was freed). Pass params={'linear_tree': True} to Dataset.")

    @property
    def _monotone_method(self) -> str:
        """The growers' monotone method: 'advanced' runs as 'intermediate'
        (reference: LeafConstraintsBase::Create; the advanced refinement is
        not implemented, warned at setup)."""
        if self._monotone is None:
            return "basic"
        return ("intermediate" if self.cfg.monotone_constraints_method
                in ("intermediate", "advanced") else "basic")

    def _forced_schedule(self):
        """forcedsplits_filename as a (leaf, feature, bin) schedule on the
        device, with its length (reference: SerialTreeLearner::ForceSplits):
        the JSON tree walked breadth first with the growers' leaf numbering
        (the left child keeps its parent's leaf, the right child of the s-th
        split is leaf s + 1), each threshold mapped to its bin by the
        training binner.  None without a file."""
        if not self.cfg.forcedsplits_filename:
            return None
        if self._forced_cache is not None:
            return self._forced_cache
        with open(self.cfg.forcedsplits_filename) as fh:
            root = json.load(fh)
        leaves, feats, bins_ = [], [], []
        queue = deque([(root, 0)])
        step = 0
        while queue:
            node, leaf = queue.popleft()
            fidx = int(node["feature"])
            mapper = self.binner.mappers[fidx]
            leaves.append(leaf)
            feats.append(fidx)
            thr = np.asarray([float(node["threshold"])])
            bins_.append(int(mapper.transform(thr)[0]))
            if node.get("left"):
                queue.append((node["left"], leaf))
            if node.get("right"):
                queue.append((node["right"], step + 1))
            step += 1
        self._forced_cache = (
            *(torch.as_tensor(np.asarray(a, np.int32), device=self.device)
              for a in (leaves, feats, bins_)), len(leaves))
        return self._forced_cache

    def _node_uniforms(self, c: int) -> torch.Tensor:
        """The per-node draws of extra_trees and feature_fraction_bynode for
        class tree ``c`` of this iteration: a (2L - 1, 2, F) table of
        uniforms from a generator on the training device seeded with
        extra_seed + iteration * 131 + c (the JAX package's per-tree seed),
        row i for node id i (0 the root, 2s + 1 and 2s + 2 the children of
        split s); [:, 0] feeds the bynode mask, [:, 1] the random
        threshold."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cfg.extra_seed + self.iter_ * 131 + c)
        L = self.cfg.num_leaves
        return torch.rand((2 * L - 1, 2, self.train_set.num_feature()),
                          generator=gen, device=self.device)

    def reset_split_params(self) -> None:
        """Refresh the split hyperparameters after a config change
        (reference: GBDT::ResetConfig via reset_parameter)."""
        cfg = self.cfg
        self._split_params = SplitParams(
            lambda_l1=cfg.lambda_l1,
            lambda_l2=cfg.lambda_l2,
            min_data_in_leaf=cfg.min_data_in_leaf,
            min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
            min_gain_to_split=cfg.min_gain_to_split,
            max_delta_step=cfg.max_delta_step,
            path_smooth=cfg.path_smooth,
            cat_l2=cfg.cat_l2,
            cat_smooth=cfg.cat_smooth,
            max_cat_threshold=cfg.max_cat_threshold,
            max_cat_to_onehot=cfg.max_cat_to_onehot,
            feature_fraction_bynode=cfg.feature_fraction_bynode,
            extra_trees=bool(cfg.extra_trees),
            monotone_penalty=cfg.monotone_penalty,
            cegb_tradeoff=cfg.cegb_tradeoff,
            cegb_penalty_split=cfg.cegb_penalty_split,
        )

    def add_valid(self, valid_set, name: str) -> None:
        valid_set.construct(reference=self.train_set, device=self.device)
        self.valid_sets.append(valid_set)
        self.valid_names.append(name)
        n = valid_set.num_data()
        k = self.num_tree_per_iteration
        shape = (n,) if k == 1 else (n, k)
        score = torch.zeros(shape, dtype=torch.float32, device=self.device)
        if any(s != 0.0 for s in self.init_scores):
            score += torch.as_tensor(np.asarray(self.init_scores, np.float32),
                                     device=self.device).reshape(-1)
        if valid_set.init_score is not None:
            score += torch.as_tensor(np.asarray(valid_set.init_score, np.float32)
                                     .reshape(shape), device=self.device)
        # a set added after training started: the trees so far, in
        # training order, on the device
        for i in range(self._num_trees()):
            self._add_score(score, self._tree_rows(i, valid_set), i % k)
        self._valid_scores.append(score)

    # ------------------------------------------------------------------
    def _all_rows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        n = self.train_set.num_data()
        if self._nobag is None or self._nobag[0].shape[0] != n:
            self._nobag = (torch.ones(n, dtype=torch.bool, device=self.device),
                           torch.ones(n, dtype=torch.float32, device=self.device))
        return self._nobag

    def _bagging_mask(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Row selection for this iteration: (mask bool, weights f32)
        (reference: BaggingSampleStrategy, bagging.hpp, and GOSSStrategy,
        goss.hpp)."""
        n = self.train_set.num_data()
        cfg = self.cfg
        dev = self.device
        if cfg.data_sample_strategy == "goss" or cfg.boosting == "goss":
            return self._goss_mask()
        use_bagging = cfg.bagging_freq > 0 and (
            cfg.bagging_fraction < 1.0
            or cfg.pos_bagging_fraction < 1.0
            or cfg.neg_bagging_fraction < 1.0
        )
        if not use_bagging:
            return self._all_rows()
        if self._last_mask is not None and (self.iter_ % cfg.bagging_freq) != 0:
            return self._last_mask  # re-bag every bagging_freq iterations
        rng = np.random.RandomState(cfg.bagging_seed + self.iter_)
        qb = self.train_set.query_boundaries
        if cfg.bagging_by_query and qb is not None:
            # whole queries, so no ranking pair straddles the bag's edge
            qmask = rng.rand(len(qb) - 1) < cfg.bagging_fraction
            mask = np.repeat(qmask, np.diff(qb))
        elif cfg.pos_bagging_fraction < 1.0 or cfg.neg_bagging_fraction < 1.0:
            lbl = np.asarray(self.train_set.label)
            mask = np.zeros(n, dtype=bool)
            pos = lbl > 0
            mask[pos] = rng.rand(int(pos.sum())) < cfg.pos_bagging_fraction
            mask[~pos] = rng.rand(int((~pos).sum())) < cfg.neg_bagging_fraction
        elif self._dp is not None:
            # this rank's slice of the serial draw over all rows
            sh = self._dp.shard
            mask = (rng.rand(sh.num_data) < cfg.bagging_fraction)[
                sh.offset:sh.offset + n]
        else:
            mask = rng.rand(n) < cfg.bagging_fraction
        self._last_mask = (torch.as_tensor(mask, device=dev),
                           torch.ones(n, dtype=torch.float32, device=dev))
        return self._last_mask

    def _goss_mask(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """GOSS on this iteration's gradients, after a warm-up of
        int(1 / learning_rate) iterations on every row (the JAX package's
        rule)."""
        cfg = self.cfg
        if self.iter_ < int(1.0 / max(cfg.learning_rate, 1e-12)):
            return self._all_rows()
        if self._dp is not None:
            # the serial selection over every rank's rows, this rank's slice
            sh, n = self._dp.shard, self.train_set.num_data()
            g, h = (self._gather_rows(v) for v in (self._cur_grad, self._cur_hess))
            mask, w = goss_mask(g, h, self._goss_uniforms(sh.num_data), cfg.top_rate,
                                cfg.other_rate)
            return mask[sh.offset:sh.offset + n], w[sh.offset:sh.offset + n]
        u = self._goss_uniforms(self.train_set.num_data())
        return goss_mask(self._cur_grad, self._cur_hess, u, cfg.top_rate,
                         cfg.other_rate)

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``t`` in the serial order (data and voting)."""
        return _coll.all_gather_ragged(t.contiguous(), self._dp.mesh)

    def _goss_uniforms(self, n: int) -> torch.Tensor:
        """GOSS's draws: (n,) uniforms from a generator on the training
        device seeded with bagging_seed + iteration."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cfg.bagging_seed + self.iter_)
        return torch.rand(n, generator=gen, device=self.device)

    def _feature_mask(self) -> torch.Tensor:
        """reference: ColSampler::ResetByTree (col_sampler.hpp)."""
        f = self.train_set.num_feature()
        frac = self.cfg.feature_fraction
        if frac >= 1.0:
            return self._allowed_features
        rng = np.random.RandomState(self.cfg.feature_fraction_seed + self.iter_)
        k = max(int(np.ceil(f * frac)), 1)
        mask = np.zeros(f, dtype=bool)
        mask[rng.choice(f, size=k, replace=False)] = True
        return torch.as_tensor(mask & self._allowed_np, device=self.device)

    def _use_strict(self) -> bool:
        """The strict grower, as the JAX package picks it: asked for, or
        auto off the accelerator (here: training on the CPU); and the
        out-of-core spill regime, whose grower mirrors it."""
        mode = self.cfg.tree_growth_mode
        if self._fp is not None:
            return True  # feature-parallel: the strict grower
        if self._dp is not None:
            return not (self._use_fast_dp() or self._use_windowed(self.train_set))
        return (mode == "strict" or (mode == "auto" and self.device.type == "cpu")
                or self._ooc_spill)

    def _use_windowed(self, ts) -> bool:
        """Wide-regime windowed grower gate (the JAX package's, with "on
        the accelerator" read as "the training device is the card"):
        windowed_growth=true, >= 512 features and >= 64 leaves, and none of
        the options its envelope excludes (monotone and interaction
        constraints, forced splits, CEGB coupled or lazy penalties, linear
        trees: they train on the rounds grower); one device is all this
        package trains on.  tree_growth_mode=windowed takes the grower at
        any width and on either device, and raises outside its envelope."""
        envelope = (self._monotone is None and self._interaction_sets is None
                    and not self.cfg.forcedsplits_filename
                    and self._cegb_lazy is None and self._cegb_coupled is None
                    and not self._linear)
        if self.cfg.tree_growth_mode == "windowed" and not self._ooc_spill:
            if not envelope:
                raise ValueError(
                    "tree_growth_mode=windowed: monotone and interaction "
                    "constraints, forced splits, CEGB coupled or lazy penalties "
                    "and linear trees train on the rounds grower")
            return True
        flag = self.cfg.extra.get("windowed_growth", False)
        if isinstance(flag, str):
            flag = flag.strip().lower() in ("1", "true", "yes", "on", "+")
        return (self.device.type == "cuda" and bool(flag)
                and ts.num_feature() >= 512 and self.cfg.num_leaves >= 64
                and envelope and self._fp is None)

    def _use_fast_dp(self) -> bool:
        """The rounds grower over sharded rows (the JAX package's gate):
        tree_learner=data with the rounds grower asked for, or auto on the
        card; voting stays on the strict grower (PV-Tree)."""
        mode = self.cfg.tree_growth_mode
        return (self._dp is not None and self.cfg.tree_learner == "data"
                and (mode in ("rounds", "windowed")
                     or (mode == "auto" and self.device.type == "cuda")))

    def _use_windowed_2d(self, ts) -> bool:
        """The 2-D mesh's gate (the JAX package's): the windowed grower's,
        less per-node feature sampling (each feature block searches only
        its features; such a training takes the data axis's rounds)."""
        return (self._dp2d is not None and not self._needs_node_rng
                and self._use_windowed(ts))

    def _use_windowed_hier(self, ts) -> bool:
        """The hierarchical mesh's gate (the JAX package's): the windowed
        grower's, less per-node feature sampling (the slice-local vote must
        be the same on every slice)."""
        return (self._dp_hier is not None and not self._needs_node_rng
                and self._use_windowed(ts))

    def _windowed_dp_merge(self) -> str:
        """The sharded windowed round's merge (the JAX package's rule):
        tree_learner=voting takes the owned-feature reduce_scatter, data the
        all_reduce; per-node sampling forces the all_reduce."""
        if self.cfg.tree_learner == "voting" and not self._needs_node_rng:
            return "scatter"
        return "psum"

    @property
    def windowed_stats(self) -> List[dict]:
        """round_stats of the windowed grower's trees."""
        return [s for s in self.round_stats if s["grower"] == "windowed"]

    def _fused_eligible(self, ts, grad=None) -> bool:
        """The JAX package's gate of its fused training step, as far as this
        package's envelope has its conditions: gradients from the objective
        (not given by the caller: custom gradients and random forests run
        eagerly), the rounds grower, float histograms (quantized training
        stays eager, as it does there), num_leaves x histogram columns <=
        100,000, a built-in objective that needs no leaf renewal and keeps
        no per-iteration host state, at most 8 trees an iteration, and none
        of CEGB coupled or lazy penalties, per-node sampling or linear trees
        (monotone, interaction and forced-split rounds stay eligible).  The
        class trees of an iteration share the captures: their rounds have
        one static key.

        A recorded departure (ROADMAP queue C6): the histogram columns are
        the bundled ones (F_b) where the Dataset has an EFB plan, where the
        JAX package counts the features.  Its limit bounds the size of an
        XLA trace, which a CUDA graph does not have; the graph and eager
        rounds grow the same trees, so only the dispatch mode differs."""
        obj = self.objective
        return (grad is None and bool(self.cfg.fused_training)
                and self._dp is None and self._fp is None
                and not self._use_windowed(ts)
                and not self._use_strict()
                and not self.cfg.use_quantized_grad
                and self.cfg.num_leaves * _hist_columns(ts) <= 100_000
                and obj is not None and not obj.need_renew and obj.is_fusable()
                and self.num_tree_per_iteration <= 8
                and self._cegb_coupled is None and self._cegb_lazy is None
                and not self._needs_node_rng and not self._linear)

    def _graphs(self, ts, grad=None) -> Optional[RoundGraphs]:
        """This training's cache of captured rounds, where the rounds run
        through one: every windowed round under fused_training, the rounds
        grower's where _fused_eligible holds."""
        if self._dp is not None or self._fp is not None:
            return None  # sharded rounds run eagerly (collectives inside)
        if not (self._fused_eligible(ts, grad)
                or (self.cfg.fused_training and self._use_windowed(ts))):
            return None
        # what sizes the static buffers; a parameter reset that changes it
        # (reset_parameter) starts a new cache
        shape = (self.cfg.num_leaves, bool(self.cfg.use_quantized_grad))
        if self._round_graphs is None or self._round_graphs_shape != shape:
            self._round_graphs = RoundGraphs(self.device)
            self._round_graphs_shape = shape
        return self._round_graphs

    # ------------------------------------------------------------------
    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting iteration (``_train_one_iter_impl``) inside the JAX
        package's telemetry: a ``boost_round`` span and event with the
        iteration's launched rounds, blocking reads, graph captures and
        replays from the sanitizer's host-side counts (no wall-clock
        delta: the launches are asynchronous), and
        ``train_boost_rounds_total``.  Nothing here reads the device."""
        if not _obs.enabled():
            return self._train_one_iter_impl(grad, hess)
        it = self.iter_
        with _san.DispatchCounter() as c, _trace.span("boost_round",
                                                     iteration=it) as sp:
            finished = self._train_one_iter_impl(grad, hess)
            d = c.stats()
            sp.set(dispatches=d["rounds"], host_syncs=d["host_syncs"],
                   captures=d["captures"], replays=d["replays"])
        _obs.counter("train_boost_rounds_total").inc()
        _obs.event("boost_round", iteration=it, dispatches=d["rounds"],
                   host_syncs=d["host_syncs"], captures=d["captures"],
                   replays=d["replays"])
        return finished

    def _train_one_iter_impl(self, grad=None, hess=None) -> bool:
        """One boosting iteration, K trees (reference: GBDT::TrainOneIter).
        ``grad``/``hess``: the caller's gradients (a custom objective),
        shaped as the score ((N,) or (N, K)); else the objective's.
        Returns True when training cannot continue (every tree of the
        iteration is a single leaf).  On the rounds and windowed growers
        that is checked every 32 iterations, as the JAX package does on
        its rounds path: a finished model only adds one-leaf trees, and a
        read every iteration would drain the device queue.  The strict
        grower checks every iteration (one blocking read an iteration), as
        the JAX package's strict path reads each host tree and stops at the
        first iteration whose trees are all one leaf.  The check also
        reads the non-finite guard."""
        ts = self.train_set
        cfg = self.cfg
        k = self.num_tree_per_iteration
        if grad is None:
            if self.objective is None:
                raise ValueError("objective=none needs gradients from the caller "
                                 "(Booster.update(fobj=...))")
            g, h = self.objective.get_gradients(self._score, self._label, self._weight)
        else:
            g = torch.as_tensor(grad, dtype=torch.float32,
                                device=self.device).reshape(self._score.shape)
            h = torch.as_tensor(hess, dtype=torch.float32,
                                device=self.device).reshape(self._score.shape)
        # fault sites of the guard-rail tests (utils/faults.py)
        if _faults.fire("nonfinite_grad", self.iter_ + 1):
            g = g.clone()
            g.view(-1)[0] = float("nan")
        if _faults.fire("nonfinite_hess", self.iter_ + 1):
            h = h.clone()
            h.view(-1)[0] = float("nan")
        self._cur_grad, self._cur_hess = g, h
        row_mask, sample_weight = self._bagging_mask()
        feature_mask = self._feature_mask()
        strict = self._use_strict()
        graphs = None if strict else self._graphs(ts, grad)
        # the strict grower trains float, as in the JAX package
        quant = bool(cfg.use_quantized_grad) and not strict
        num_leaves = []
        # the distributed learners do not thread the forced schedule (warned)
        fs = (None if self._dp is not None or self._fp is not None
              else self._forced_schedule())
        for c in range(k):
            gc = g if k == 1 else g[:, c].contiguous()
            hc = h if k == 1 else h[:, c].contiguous()
            args = (ts.bins_device, gc, hc, row_mask, sample_weight, feature_mask,
                    ts.num_bins_pf_device, ts.missing_bin_pf_device)
            efb = None if strict or self._dp is not None else ts.efb_device_tables()
            stats: dict = {}
            common = dict(num_leaves=cfg.num_leaves, num_bins=ts.max_num_bins,
                          max_depth=cfg.max_depth, params=self._split_params,
                          stats=stats, categorical_mask=self._categorical_mask,
                          feature_contri=self._feature_contri,
                          rng_key=(self._node_uniforms(c) if self._needs_node_rng
                                   else None))
            # the rest of the envelope (the windowed grower's gate excludes it)
            envelope = dict(
                monotone_constraints=self._monotone,
                interaction_sets=self._interaction_sets,
                # recomputed per class tree: a feature an earlier tree used
                # is no longer charged (reference: cegb.hpp's coupled state)
                cegb_feature_penalty=(
                    None if self._cegb_coupled is None
                    else torch.where(self._cegb_used_global, 0.0, self._cegb_coupled)),
                cegb_lazy_penalty=self._cegb_lazy,
                cegb_lazy_used=self._cegb_lazy_used,
                forced_leaf=fs[0] if fs else None,
                forced_feature=fs[1] if fs else None,
                forced_bin=fs[2] if fs else None, n_forced=fs[3] if fs else 0,
                track_path=self._linear, monotone_method=self._monotone_method)
            if self._ooc_spill:
                stats["grower"] = "ooc"
                out = grow_tree_ooc(
                    ts.device_chunks, ts.num_data(), ts.num_feature(), *args[1:],
                    num_leaves=cfg.num_leaves, num_bins=ts.max_num_bins,
                    max_depth=cfg.max_depth, params=self._split_params, stats=stats,
                    categorical_mask=self._categorical_mask,
                    feature_contri=self._feature_contri)
            elif self._fp is not None:
                stats["grower"] = "strict"
                out = _fpar.grow_tree_feature_parallel(
                    self._fp, *args[1:6], self._categorical_mask,
                    self._monotone, self._interaction_sets, common["rng_key"],
                    self._feature_contri, num_leaves=cfg.num_leaves,
                    num_bins=ts.max_num_bins, max_depth=cfg.max_depth,
                    params=self._split_params, stats=stats,
                    monotone_method=self._monotone_method,
                    cegb_feature_penalty=envelope["cegb_feature_penalty"])
            elif strict and self._dp is not None:
                stats["grower"] = "strict"
                out = _dpar.grow_tree_data_parallel(
                    self._dp, *args[1:6], self._categorical_mask, self._monotone,
                    self._interaction_sets, common["rng_key"], self._feature_contri,
                    num_leaves=cfg.num_leaves, num_bins=ts.max_num_bins,
                    max_depth=cfg.max_depth, params=self._split_params,
                    stats=stats, parallel_mode=("voting" if cfg.tree_learner
                                                == "voting" else "data"),
                    top_k=int(cfg.top_k), monotone_method=self._monotone_method,
                    cegb_feature_penalty=envelope["cegb_feature_penalty"])
            elif strict:
                stats["grower"] = "strict"
                out = grow_tree(*args, **common, **envelope)
            else:
                gen = None
                if quant:
                    gen = torch.Generator(device=self.device)
                    gen.manual_seed(cfg.seed * 1000003 + self.iter_ * 31 + c)
                common.update(
                    leaf_tile=self._leaf_tile,
                    quantize_bins=(cfg.num_grad_quant_bins if quant else 0),
                    stochastic_rounding=bool(cfg.stochastic_rounding),
                    quant_renew=bool(cfg.quant_train_renew_leaf),
                    generator=gen, graphs=graphs, efb=efb,
                    hist_precision=cfg.hist_precision,
                    guard_label=f" (boosting iteration {self.iter_ + 1})")
                if self._dp is not None:
                    # sharded rows: the round's merge is a collective
                    common.update(axis_name=self._dp.shard)
                    for key in ("graphs", "efb"):
                        common.pop(key)
                mesh_kw = {k: v for k, v in common.items()
                           if k not in ("rng_key", "axis_name")}
                if self._use_windowed_2d(ts):
                    stats["grower"] = "windowed_2d"
                    out = _f2d.grow_tree_windowed_feature2d(self._dp2d, *args[1:6],
                                                            **mesh_kw)
                elif self._use_windowed_hier(ts):
                    stats["grower"] = "windowed_hier"
                    out = _hier.grow_tree_windowed_hierarchical(
                        self._dp_hier, *args[1:6], merge=self._windowed_dp_merge(),
                        top_k_features=int(cfg.top_k_features), **mesh_kw)
                elif self._use_windowed(ts):
                    stats["grower"] = "windowed"
                    if self._dp is not None:
                        common["merge"] = self._windowed_dp_merge()
                    out = grow_tree_windowed(
                        *args, megakernel_opt=cfg.extra.get("megakernel"), **common)
                else:
                    stats["grower"] = "rounds"
                    out = grow_tree_fast(*args, **common, **envelope)
            arrays, leaf_id = out[:2]
            if self._cegb_lazy is not None:
                self._cegb_lazy_used = out[2]
            self.round_stats.append(stats)
            arrays = self._renew(arrays, leaf_id, c)
            self._guard_accumulate(arrays)
            linear_fit = lin_pred = None
            if self._linear:
                used_path = arrays.path_features
                if self._categorical_mask is not None:
                    used_path = used_path & ~self._categorical_mask[None, :]
                coef, const, fidx, nf, lin_pred, _good = fit_linear_leaves(
                    ts.raw_device, leaf_id, gc * sample_weight, hc * sample_weight,
                    row_mask, used_path, arrays.leaf_value, float(cfg.linear_lambda),
                    # at most 24 path features a leaf model (the JAX
                    # package's cap; deeper paths keep the lowest indices)
                    K=min(24, ts.num_feature()), num_leaves=cfg.num_leaves)
                linear_fit = (coef, const, fidx, nf)
            if self._cegb_coupled is not None:
                valid = (torch.arange(cfg.num_leaves - 1, device=self.device)
                         < arrays.num_leaves - 1)
                hit = torch.zeros(ts.num_feature() + 1, dtype=torch.bool,
                                  device=self.device)
                f_nodes = torch.where(valid, arrays.split_feature.long(),
                                      ts.num_feature())
                hit[f_nodes] = True
                self._cegb_used_global = self._cegb_used_global | hit[:-1]
            num_leaves.append(arrays.num_leaves)
            shrinkage = 1.0 if self.average_output else cfg.learning_rate
            self._pending.append([arrays, [shrinkage], linear_fit])
            # bumped at the append, not at the host read: a pack built from
            # here on must not be keyed as the version before this tree
            self._invalidate_pred_cache("train_one_iter")
            if linear_fit is not None:
                delta_rows = lin_pred * np.float32(shrinkage)
            elif strict:
                # the JAX package's strict path scales the host tree in f64
                delta = (arrays.leaf_value.double() * shrinkage).float()
                delta_rows = delta[leaf_id.long()]
            else:
                delta = arrays.leaf_value * np.float32(shrinkage)
                delta_rows = delta[leaf_id.long()]
            self._add_score(self._score, delta_rows, c)
            for vi, vs in enumerate(self.valid_sets):
                leaf_v = predict_leaf_arrays(
                    arrays, vs.bins_device, ts.missing_bin_pf_device,
                    categorical=self._categorical_mask is not None).long()
                if linear_fit is not None:
                    vals = predict_linear_rows(vs.raw_device, leaf_v, *linear_fit,
                                               arrays.leaf_value) * np.float32(shrinkage)
                else:
                    vals = delta[leaf_v]
                self._add_score(self._valid_scores[vi], vals, c)
        self.iter_ += 1
        if not strict and self.iter_ % 32:
            return False
        read = _san.sync_pull(torch.stack([torch.stack(num_leaves).max(),
                                           self._guard_bad_iter]))
        self._raise_if_nonfinite(int(read[1]))
        return int(read[0]) <= 1

    def _add_score(self, score: torch.Tensor, delta: torch.Tensor, c: int) -> None:
        """score (+)= delta in place, into class column c of a (N, K) score."""
        if score.dim() == 1:
            score += delta
        else:
            score[:, c] += delta

    def _renew(self, arrays, leaf_id, c: int):
        """Leaf outputs renewed from the residuals where the objective asks
        for it (reference: RenewTreeOutput after the tree is grown)."""
        obj = self.objective
        if obj is None or not obj.need_renew:
            return arrays
        score = self._score if self._score.dim() == 1 else self._score[:, c]
        label, weight = self._label, self._weight
        if self._dp is not None:  # over every rank's rows, as the serial run
            label, score, leaf_id = (self._gather_rows(v) for v in (label, score, leaf_id))
            weight = None if weight is None else self._gather_rows(weight)
        renewed = obj.renew_tree_output(label, weight, score, leaf_id,
                                        self.cfg.num_leaves)
        active = (torch.arange(self.cfg.num_leaves, device=self.device)
                  < arrays.num_leaves)
        return arrays._replace(leaf_value=torch.where(active, renewed, 0.0))

    def _guard_accumulate(self, arrays) -> None:
        """Fold the tree's finiteness into the device guard, no host read."""
        ok = (torch.isfinite(arrays.leaf_value).all()
              & ~torch.isnan(arrays.split_gain).any())
        self._guard_bad_iter = torch.where(
            (self._guard_bad_iter == 0) & ~ok, self.iter_ + 1, self._guard_bad_iter
        ).to(torch.int32)

    def _raise_if_nonfinite(self, bad: int) -> None:
        if bad:
            _obs.counter("train_nonfinite_errors_total").inc()
            _obs.event("nonfinite", phase="guard_check", iteration=bad)
            raise NonFiniteError(
                f"non-finite leaf values or split gains entered the model at "
                f"boosting iteration {bad}: the gradients or hessians went "
                "NaN/inf (check labels, weights and the objective)")

    # ------------------------------------------------------------------
    def rollback_one_iter(self) -> None:
        """Drop the last iteration's trees and take their values out of
        every score (reference: GBDT::RollbackOneIter), on the device."""
        if self.iter_ <= 0:
            return
        k = self.num_tree_per_iteration
        with self._plock():  # the pops and the bump, atomic for _packed
            for c in reversed(range(k)):
                i = self._num_trees() - 1
                for ds, score in self._scored_sets():
                    self._add_score(score, -self._tree_rows(i, ds), c)
                if self._pending:
                    self._pending.pop()
                else:
                    self._models.pop()
            self.iter_ -= 1
            self._invalidate_pred_cache("rollback_one_iter")

    # ------------------------------------------------------------------
    def _converted(self, score: torch.Tensor) -> np.ndarray:
        if self.objective is not None:
            score = self.objective.convert_output(score)
        return score.cpu().numpy()

    def _eval_margin(self, score: torch.Tensor) -> torch.Tensor:
        """The margin the metrics read (RF averages it)."""
        return score

    def eval_at(self, data_idx: int) -> List[Tuple[str, str, float, bool]]:
        """data_idx 0 = training, 1.. = valid sets (reference:
        GBDT::GetEvalAt) -> (dataset_name, metric_name, value, higher_better)."""
        if data_idx == 0:
            ds, score, name = self.train_set, self._score, self.train_name
        else:
            ds = self.valid_sets[data_idx - 1]
            score = self._valid_scores[data_idx - 1]
            name = self.valid_names[data_idx - 1]
        if self._guard_bad_iter is not None:  # eval reads the device anyway
            self._raise_if_nonfinite(int(_san.sync_pull(self._guard_bad_iter)))
        if self._dp is not None:
            return self._eval_at_synced(ds, score, name)
        pred = self._converted(self._eval_margin(score))
        label = np.asarray(ds.label)
        out = []
        for m in self.metrics:
            for mn, v, hib in m.eval(pred, label, ds.weight, ds.query_boundaries):
                out.append((name, mn, v, hib))
        return out

    def _eval_at_synced(self, ds, score, name) -> List[Tuple[str, str, float, bool]]:
        """Metrics over every rank's rows (reference: Metric::Eval with
        Network::GlobalSyncUpBySum): each rank's predictions, labels,
        weights and query sizes are gathered in rank order, which is the
        serial row order, and every rank evaluates the whole, so every rank
        (and early stopping) sees the serial values."""
        mesh = self._dp.mesh
        dev = self.device

        def gather(a):  # in the array's own dtype, so the values are the serial ones
            t = torch.as_tensor(np.ascontiguousarray(a), device=dev)
            return _coll.all_gather_ragged(t, mesh).cpu().numpy()

        pred = gather(self._converted(self._eval_margin(score)))
        label = gather(np.asarray(ds.label))
        weight = None if ds.weight is None else gather(np.asarray(ds.weight))
        qb = ds.query_boundaries
        if qb is not None:
            sizes = gather(np.diff(np.asarray(qb)).astype(np.int64))
            qb = np.concatenate([[0], np.cumsum(sizes)])
        out = []
        for m in self.metrics:
            for mn, v, hib in m.eval(pred, label, weight, qb):
                out.append((name, mn, v, hib))
        return out

    # ------------------------------------------------------------------
    def _stacked(self, trees: List[Tree], device) -> Dict[str, torch.Tensor]:
        """Stacked structure-of-arrays ensemble for the traversal, with the
        depth of its deepest tree (the traversal's step count) and, when a
        tree has categorical nodes, their bitsets (``cat``: per node a
        flag, a word base and a word count into the flat words of every
        tree, as the JAX package stacks them)."""
        max_l = max(max(t.num_leaves for t in trees), 2)
        m = max_l - 1

        def pad(get, dtype, width, fill=0):
            out = np.full((len(trees), width), fill, dtype=dtype)
            for i, t in enumerate(trees):
                a = get(t)
                out[i, : len(a)] = a
            return torch.as_tensor(out, device=device)

        return dict(
            split_feature=pad(lambda t: t.split_feature, np.int32, m),
            threshold=pad(lambda t: _f32_threshold_upper(t.threshold), np.float32, m),
            default_left=pad(lambda t: t.default_left(), bool, m),
            missing_type=pad(
                lambda t: (t.decision_type.astype(np.int32) >> 2) & 3, np.int32, m),
            left_child=pad(lambda t: t.left_child, np.int32, m, fill=-1),
            right_child=pad(lambda t: t.right_child, np.int32, m, fill=-1),
            num_leaves=torch.as_tensor([t.num_leaves for t in trees],
                                       dtype=torch.int32, device=device),
            leaf_value=pad(lambda t: t.leaf_value, np.float32, max_l),
            depth=max(tree_depth(t) for t in trees),
            cat=_stacked_bitsets(trees, m, device),
        )

    # -- the packed-ensemble cache (the JAX package's _packed) ----------
    _PACKED_CACHE_CAP = 32  # bounds the early-stop windows' entries etc.
    # versions kept after a mutation: the current one and the previous one
    # (in-flight readers of the pack before the mutation)
    _PACKED_KEEP_VERSIONS = 2

    def _packed(self, start: int = 0, num_iteration: int = -1, *,
                pad_trees_to: int = 0) -> Optional[dict]:
        """The stacked ensemble of iterations [start, start +
        num_iteration) on the device, built once a (version, tree range,
        model state) and cached, so a warm predict builds and uploads
        nothing; None for an ensemble without trees.  ``pad_trees_to``
        pads the tree axis with one-leaf zero trees to a multiple of that
        window (the early-stop chunks).

        A pack is ``walk`` (``_stacked``'s tensors, what the traversal
        takes), ``trees`` (the export trees), ``linear`` (any tree with
        leaf models), ``lin`` (their tables on the device) and ``served``
        (a predict has read through it).  The lookup holds the pack lock,
        which the version bump holds too; the build runs outside it, and a
        build that a mutation overtook is built again under the new version
        (after three lost races, under the lock)."""
        races = 0
        while True:
            if races >= 3:
                with self._plock():
                    return self._packed_build_locked(start, num_iteration,
                                                     pad_trees_to)
            with self._plock():
                v0 = self._pack_version
                key = self._pack_key(start, num_iteration, pad_trees_to)
                if self._pred_cache is None:
                    self._pred_cache = {}
                if key in self._pred_cache:
                    _obs.counter("predict_packed_cache_hits_total").inc()
                    return self._pred_cache[key]
                _obs.counter("predict_packed_cache_misses_total").inc()
            s = self._pack(start, num_iteration, pad_trees_to)
            with self._plock():
                if self._pack_version != v0:
                    _obs.counter("predict_pack_build_races_total").inc()
                    races += 1
                    continue
                self._pack_insert(key, s)
                return s

    def _pack_key(self, start: int, num_iteration: int, pad_trees_to: int) -> tuple:
        """(version, first tree, end tree, trees, pad): the model's trees
        are read (pending ones made host trees) under the pack lock."""
        k = self.num_tree_per_iteration
        n_models = len(self.models)
        hi = n_models if num_iteration < 0 else min((start + num_iteration) * k,
                                                    n_models)
        return (self._pack_version, start * k, hi, n_models, pad_trees_to)

    def _pack_insert(self, key: tuple, s: Optional[dict]) -> None:
        if len(self._pred_cache) >= self._PACKED_CACHE_CAP:
            self._pred_cache.pop(next(iter(self._pred_cache)))
        self._pred_cache[key] = s

    def _packed_build_locked(self, start: int, num_iteration: int,
                             pad_trees_to: int) -> Optional[dict]:
        """Lookup, build and insert with the pack lock held: no mutation
        can overtake it (``_packed`` after repeated races)."""
        key = self._pack_key(start, num_iteration, pad_trees_to)
        if self._pred_cache is None:
            self._pred_cache = {}
        if key in self._pred_cache:
            _obs.counter("predict_packed_cache_hits_total").inc()
            return self._pred_cache[key]
        _obs.counter("predict_packed_cache_misses_total").inc()
        s = self._pack(start, num_iteration, pad_trees_to)
        self._pack_insert(key, s)
        return s

    def _pack(self, start: int, num_iteration: int, pad_trees_to: int) -> Optional[dict]:
        trees = self._trees_for_export(start, num_iteration)
        if not trees:
            return None
        walk_trees = trees
        if pad_trees_to:
            walk_trees = trees + [_dummy_tree()] * (-len(trees) % pad_trees_to)
        linear = any(t.is_linear for t in trees)
        return dict(
            walk=self._stacked(walk_trees, self.device), trees=trees, linear=linear,
            lin=([_linear_tables(t, self.device) for t in walk_trees] if linear
                 else None),
            served=False)

    def _chunks(self, x: torch.Tensor, n_trees: int):
        """Row chunks of the device batch ``x``: the traversal holds a few
        (trees, rows) int64 planes, each kept near 2^25 elements."""
        step = max(1, 2 ** 25 // max(n_trees, 1))
        return [x[i:i + step] for i in range(0, max(x.shape[0], 1), step)]

    def _raw_of(self, s: dict, x: torch.Tensor) -> torch.Tensor:
        """Raw margins of the device rows ``x`` (f32): (n,) or (n, K) f32
        on the device, the trees' sum in tree order (a random forest's
        unscaled)."""
        k = self.num_tree_per_iteration
        walk = s["walk"]
        n_trees = len(s["trees"])
        if s["linear"]:
            return torch.cat([self._linear_raw(s, xs) for xs in self._chunks(x, n_trees)])
        if k == 1:
            fn = predict_ops.predict_raw_values
        else:
            def fn(xs, **kw):
                return predict_ops.predict_raw_multiclass(xs, **kw, k=k)
        return torch.cat([fn(xs, **walk) for xs in self._chunks(x, n_trees)])

    def _linear_raw(self, s: dict, xs: torch.Tensor) -> torch.Tensor:
        """Raw margins of an ensemble with linear trees on the device: the
        traversal's leaf of every (row, tree), then each linear tree's leaf
        model on the raw values (ops/linear.py::predict_linear_rows), a
        constant tree's leaf value, summed per class in tree order."""
        k = self.num_tree_per_iteration
        trees = s["trees"]
        out = torch.zeros((xs.shape[0], k), dtype=torch.float32, device=xs.device)
        _add_trees(trees, xs, _leaves_of(xs, s["walk"]), 0, len(trees), k, out,
                   s["lin"])
        return out[:, 0] if k == 1 else out

    def _stage(self, X: np.ndarray, nb: int) -> torch.Tensor:
        """X as f32 rows on the device.  On the card through the model's
        pinned input buffer of rung ``nb`` (the f64 -> f32 cast is the copy
        into it, the same rounding as numpy's), uploaded without blocking;
        the caller holds the pinned lock until its read is done, which also
        retires these uploads before a buffer is written again.  A rung too
        large to pin goes through two pinned chunk buffers in turns, each
        written again only after the event behind its last upload."""
        if self.device.type != "cuda":
            return torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        n, f = X.shape
        src = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float64))
        buf, _ = self._pinned.get((nb, f), torch.float32)
        if buf is not None:
            buf[:n].copy_(src)
            return buf[:n].to(self.device, non_blocking=True)
        step = max(1, _PINNED_MAX_BYTES // (4 * f))
        out = torch.empty((n, f), dtype=torch.float32, device=self.device)
        events = (torch.cuda.Event(), torch.cuda.Event())
        for i, lo in enumerate(range(0, n, step)):
            chunk, _ = self._pinned.get((step, f), torch.float32, slot=1 + i % 2)
            events[i % 2].synchronize()
            m = min(step, n - lo)
            chunk[:m].copy_(src[lo:lo + m])
            out[lo:lo + m].copy_(chunk[:m], non_blocking=True)
            events[i % 2].record()
        return out

    def _pull(self, s: dict, t: torch.Tensor, nb: int) -> Tuple[np.ndarray, bool]:
        """The one blocking read of a prediction: ``t`` into the model's
        pinned output buffer of rung ``nb`` (allocated at the rung's first
        read; pageable memory for a rung too large to pin), copied out as a
        new array.  Returns (array, warm): warm when the pack ``s`` has
        served before and no buffer was allocated.  The caller holds the
        pinned lock."""
        served, s["served"] = s["served"], True
        buf, new = None, False
        if self.device.type == "cuda":
            buf, new = self._pinned.get((nb,) + tuple(t.shape[1:]), t.dtype)
        if buf is None:
            return np.array(_san.sync_pull(t)), served
        return np.array(_san.sync_pull(t, out=buf)), served and not new

    def _finish(self, s: dict, raw: torch.Tensor, raw_score: bool, nb: int,
                scale: float) -> Tuple[np.ndarray, bool]:
        """Margins or converted outputs of the device margins ``raw``, in
        one read (``_pull``): a random forest's tree sum times ``scale`` in
        f64 (as the JAX package scales it on the host: the same IEEE
        products), a raw margin as f64, a converted output in the
        objective's dtype."""
        if self.average_output:
            raw = raw.double() * scale
            if raw_score or self.objective is None:
                return self._pull(s, raw, nb)
            raw = raw.float()
        elif raw_score or self.objective is None:
            out, warm = self._pull(s, raw, nb)
            return out.astype(np.float64), warm
        return self._pull(s, self.objective.convert_output(raw), nb)

    def _serve_note(self, entry: str, n: int, t0: float, bucket: int, warm: bool,
                    trace_ctx=None) -> None:
        """Record one prediction call, after its blocking read (so the time
        covers the device work): requests and rows, and a warm call's
        latency in ``predict_warm_latency_ms`` (labelled by entry and by
        rung too).  A call is cold when it built its pack or its rung's
        buffers; cold calls count as bucket misses and stay out of the
        reservoirs.  The ``predict.<entry>`` span records the same
        interval, a child of ``trace_ctx`` when a serving dispatcher gives
        one."""
        if not _obs.enabled():
            return
        dt_ms = (time.perf_counter() - t0) * 1e3
        _obs.counter("predict_requests_total").inc()
        _obs.counter("predict_rows_total").inc(n)
        if warm:
            _obs.counter("predict_bucket_hits_total").inc()
            _obs.histogram("predict_warm_latency_ms").observe(dt_ms)
            _obs.histogram(_obs.labeled("predict_warm_latency_ms",
                                        entry=entry)).observe(dt_ms)
            _obs.histogram(_obs.labeled("predict_warm_latency_ms",
                                        bucket=bucket)).observe(dt_ms)
        else:
            _obs.counter("predict_bucket_misses_total").inc()
        _trace.record_span(f"predict.{entry}", dt_ms / 1e3, parent=trace_ctx,
                           rows=n, bucket=bucket, warm=warm)

    def predict_raw(self, X: np.ndarray, start_iteration: int = 0,
                    num_iteration: int = -1) -> torch.Tensor:
        """Raw margins, (N,) or (N, K) f32 on the device, from the export
        trees (init score folded into each class's first tree, as in a
        saved model), so an in-memory model and its text round-trip predict
        identically.  A random forest's are the trees' sum (``predict``
        averages it).  Reads nothing back."""
        s = self._packed(start_iteration, num_iteration)
        if s is None:
            return self._init_only(np.asarray(X).shape[0])
        _san.record_predict()
        return self._raw_of(s, torch.as_tensor(np.asarray(X, np.float32),
                                               device=self.device))

    def _init_only(self, n: int) -> torch.Tensor:
        k = self.num_tree_per_iteration
        base = torch.as_tensor(np.asarray(self.init_scores, np.float32),
                               device=self.device)
        out = base.expand(n, k).clone()
        return out[:, 0] if k == 1 else out

    def _pack_scale(self, s: dict) -> float:
        """A random forest's 1 / (the pack's trees a class), else 1."""
        if not self.average_output:
            return 1.0
        return 1.0 / max(len(s["trees"]) // self.num_tree_per_iteration, 1)

    def _early_stop_on(self, settings: Optional[dict]) -> bool:
        on = (settings or {}).get("pred_early_stop", self.cfg.pred_early_stop)
        return (bool(on) and not self.average_output and self.objective is not None
                and self.objective.name in ("binary", "multiclass", "multiclassova"))

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: int = -1, pred_leaf: bool = False,
                pred_contrib: bool = False,
                early_stop: Optional[dict] = None, mesh=None) -> np.ndarray:
        """The JAX package's GBDT.predict.  ``early_stop``: pred_early_stop,
        pred_early_stop_freq and pred_early_stop_margin for this call,
        over the configuration's.  A warm call (its pack cached, its rung
        seen) stages the rows through the pack's pinned input buffer,
        launches the traversal and makes one blocking read into the pinned
        output buffer: no ensemble is built on the host.  ``mesh``: the
        margins from ``predict_raw_sharded`` (early stopping, pred_leaf
        and pred_contrib keep this path)."""
        X = np.asarray(X, dtype=np.float64)
        if pred_leaf:
            return self._predict_leaf(X, start_iteration, num_iteration)
        if pred_contrib:
            return self.predict_contrib(X, start_iteration, num_iteration)
        if self._early_stop_on(early_stop):
            raw = self._predict_raw_early_stop(X, start_iteration, num_iteration,
                                               early_stop)
            if raw_score:
                return raw
            return self._converted(torch.as_tensor(raw.astype(np.float32),
                                                   device=self.device))
        s = self._packed(start_iteration, num_iteration)
        n = X.shape[0]
        if s is None:
            raw = self._init_only(n)
            if raw_score or self.objective is None:
                return raw.cpu().numpy().astype(np.float64)
            return self.objective.convert_output(raw).cpu().numpy()
        t0 = time.perf_counter()
        nb = _predict_bucket(n)
        scale = self._pack_scale(s)
        with self._pinned.lock:
            _san.record_predict()
            raw = (self._raw_of(s, self._stage(X, nb)) if mesh is None
                   else self._raw_sharded(s, X, mesh))
            res, warm = self._finish(s, raw, raw_score, nb, scale)
        self._serve_note("raw" if raw_score else
                         "predict" if mesh is None else "sharded", n, t0, nb, warm)
        return res

    def predict_raw_sharded(self, X: np.ndarray, mesh, start_iteration: int = 0,
                            num_iteration: int = -1) -> np.ndarray:
        """Raw margins (f64) with the rows split over ``mesh``: bitwise
        ``predict(raw_score=True)`` (``_raw_sharded``)."""
        return self.predict(X, raw_score=True, start_iteration=start_iteration,
                            num_iteration=num_iteration, mesh=mesh)

    def _raw_sharded(self, s: dict, X: np.ndarray, mesh) -> torch.Tensor:
        """The pack's margins of ``X`` with its rows in contiguous blocks:
        over a DeviceMesh (parallel/mesh.py::make_device_mesh) one block a
        device, the pack's tables placed on each device once and cached in
        the pack (``mesh_walk``), the blocks' margins gathered on the
        training device; over a process group's mesh (a Mesh, or a 2-D or
        hierarchical mesh's world) this rank's block, every rank's gathered
        by all_gather_ragged (every rank passes the same ``X``).  Each
        row's margin is its own traversal, so the blocks' are predict's
        bit for bit."""
        from ..parallel.mesh import WORLD_AXIS, DeviceMesh, GridMesh, Mesh

        n = X.shape[0]
        if not isinstance(mesh, (DeviceMesh, GridMesh, Mesh)):
            raise TypeError(f"mesh must be a DeviceMesh (parallel/mesh.py::"
                            f"make_device_mesh) or a process group's mesh, got "
                            f"{type(mesh).__name__}")
        if isinstance(mesh, DeviceMesh):
            per = -(-max(n, 1) // mesh.size)
            cache = s.setdefault("mesh_walk", {})
            raws = []
            for i, dev in enumerate(mesh.devices):
                walk = cache.get(str(dev))
                if walk is None:
                    walk = cache[str(dev)] = _walk_on(s["walk"], dev)
                block = X[i * per:(i + 1) * per]
                x = torch.as_tensor(np.asarray(block, np.float32), device=dev)
                raws.append(self._raw_of({**s, "walk": walk}, x))
            return torch.cat([r.to(self.device) for r in raws])
        group = mesh.axes[WORLD_AXIS] if isinstance(mesh, GridMesh) else mesh
        per = -(-max(n, 1) // group.size)
        block = X[group.rank * per:(group.rank + 1) * per]
        raw = self._raw_of(s, torch.as_tensor(np.asarray(block, np.float32),
                                              device=self.device))
        return _coll.all_gather_ragged(raw.contiguous(), group)

    def _coalescible(self, raw_score: bool) -> bool:
        """Whether ``predict(raw_score=)`` can be served by
        ``predict_coalesced``, bitwise: a packed ensemble without linear
        leaves, and no prediction early stopping (its trees a row depend on
        the margins).  A random forest's converted output is coalescible
        here (its f64 scale runs on the device in the one read)."""
        if self._early_stop_on(None):
            return False
        s = self._packed(0, -1)
        return s is not None and not s["linear"]

    def predict_coalesced(self, x: torch.Tensor, *, convert: bool,
                          trace_ctx=None) -> np.ndarray:
        """One coalesced serving batch (serve/runtime.py): ``x`` is the
        staged (n, F) f32 rows of the batch's requests on the device.  One
        traversal and one blocking read for the whole batch; each request's
        rows, sliced out, are bitwise its own ``predict``, since rows
        traverse independently and the conversions are row-wise.
        ``convert=False`` gives raw margins as ``predict(raw_score=True)``.
        Raises for a model that is not coalescible."""
        s = self._packed(0, -1)
        if s is None or s["linear"]:
            raise ValueError("predict_coalesced: the model is not coalescible "
                             "(no trees, or linear leaves): use predict()")
        t0 = time.perf_counter()
        n = x.shape[0]
        nb = _predict_bucket(n)
        with self._pinned.lock:
            _san.record_predict()
            raw = self._raw_of(s, x)
            res, warm = self._finish(s, raw, not convert, nb, self._pack_scale(s))
        self._serve_note("coalesced", n, t0, nb, warm, trace_ctx=trace_ctx)
        return res

    def _predict_leaf(self, X: np.ndarray, start_iteration: int = 0,
                      num_iteration: int = -1) -> np.ndarray:
        """pred_leaf: (N, T) i32 leaf ids from the value path's traversal."""
        s = self._packed(start_iteration, num_iteration)
        if s is None:
            return np.zeros((X.shape[0], 0), dtype=np.int32)
        x = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        walk = {key: v for key, v in s["walk"].items() if key != "leaf_value"}
        _san.record_predict()
        out = torch.cat([predict_ops.predict_leaf_values(xs, **walk)
                         for xs in self._chunks(x, len(s["trees"]))])
        return _san.sync_pull(out)

    def _predict_raw_early_stop(self, X: np.ndarray, start_iteration: int = 0,
                                num_iteration: int = -1,
                                settings: Optional[dict] = None) -> np.ndarray:
        """Prediction early stopping (reference: prediction_early_stop.h):
        every pred_early_stop_freq iterations, rows whose margin (|raw| for
        binary, top1 - top2 for multiclass) is past pred_early_stop_margin
        stop taking trees.  Each chunk is one window of trees on the device
        over every row (the stopped ones masked) and one blocking read of
        the margins, which the stop test needs on the host; a row that runs
        every chunk ends at the full prediction, bitwise.  The packed
        ensemble (padded to whole windows) comes from the cache.  The
        counts of the last call are in ``early_stop_stats``."""
        settings = settings or {}
        cfg = self.cfg
        k = self.num_tree_per_iteration
        total = self._num_trees() // k
        if num_iteration is not None and num_iteration >= 0:
            total = min(total, start_iteration + num_iteration)
        freq = max(int(settings.get("pred_early_stop_freq", cfg.pred_early_stop_freq)), 1)
        margin = float(settings.get("pred_early_stop_margin", cfg.pred_early_stop_margin))
        n = X.shape[0]
        n_iters = total - start_iteration
        self.early_stop_stats = dict(chunks=0, reads=0, stopped=0)
        if n_iters <= 0:
            return self.predict_raw(X, start_iteration, 0).cpu().numpy().astype(np.float64)
        freq = min(freq, n_iters)
        window = freq * k
        p = self._packed(start_iteration, n_iters, pad_trees_to=window)
        s, lin = p["walk"], p["lin"]
        n_walk = s["num_leaves"].shape[0]
        x = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        shape = (n,) if k == 1 else (n, k)
        raw_dev = torch.zeros(shape, dtype=torch.float32, device=self.device)
        active = np.ones(n, dtype=bool)
        raw = np.zeros(shape, dtype=np.float64)
        # linear leaves: the window's trees added onto the margins in tree
        # order (_add_trees), as _linear_raw adds all of them
        trees = p["trees"] + [_dummy_tree()] * (n_walk - len(p["trees"]))
        leaves = _leaves_of(x, s) if p["linear"] else None
        for ci in range(n_walk // window):
            act = torch.as_tensor(active, device=self.device)
            if leaves is None:
                raw_dev = predict_ops.predict_raw_window(
                    x, ci * window, **s, k=k, window=window, base=raw_dev, active=act)
            else:
                acc = raw_dev.reshape(n, k)
                nxt = _add_trees(trees, x, leaves, ci * window, (ci + 1) * window, k,
                                 acc.clone(), lin)
                raw_dev = torch.where(act[:, None], nxt, acc).reshape(shape)
            # the stop test is a host dependency: one blocking read a chunk
            raw = _san.sync_pull(raw_dev).astype(np.float64)
            self.early_stop_stats["chunks"] += 1
            self.early_stop_stats["reads"] += 1
            active &= self._early_stop_active(raw, margin)
            if not active.any():
                break
        self.early_stop_stats["stopped"] = int(n - active.sum())
        return raw

    @staticmethod
    def _early_stop_active(raw: np.ndarray, margin: float) -> np.ndarray:
        """Rows whose margin has not yet cleared pred_early_stop_margin."""
        if raw.ndim == 1:
            m = np.abs(raw)
        else:
            top2 = np.partition(raw, -2, axis=1)[:, -2:]
            m = top2[:, 1] - top2[:, 0]
        return m < margin

    def predict_contrib(self, X, start_iteration: int = 0,
                        num_iteration: int = -1) -> np.ndarray:
        """SHAP values by the per-tree path algorithm over the export trees
        (reference: Tree::PredictContrib), on the host: (N, (F + 1) * K)."""
        if any(t.is_linear for t in self.models):
            raise ValueError("predict_contrib is not supported for linear trees")
        from .shap import tree_shap_ensemble

        trees = self._trees_for_export(start_iteration, num_iteration)
        return tree_shap_ensemble(trees, np.asarray(X, np.float64),
                                  self.num_tree_per_iteration)

    def to_if_else(self) -> str:
        """Standalone C++ predictor source (reference: task=convert_model,
        GBDT::SaveModelToIfElse): float64 code, equal to the host f64 tree
        walk of the export trees."""
        trees = self._trees_for_export(0, -1)
        k = self.num_tree_per_iteration
        parts = ["// Generated by lightgbm_tpu task=convert_model", "#include <cmath>", ""]
        for i, t in enumerate(trees):
            parts.append(tree_to_if_else(t, i))
            parts.append("")
        n_per_class = max(len(trees) // k, 1) if trees else 1
        scale = (1.0 / n_per_class) if self.average_output else 1.0
        calls = " + ".join(f"PredictTree{i}(x)" for i in range(len(trees))) or "0.0"
        if k == 1:
            parts.append("extern \"C\" double PredictRaw(const double* x) {")
            parts.append(f"  return ({calls}) * {scale:.17g};")
            parts.append("}")
            parts.append("extern \"C\" double Predict(const double* x) {")
            if self._objective_string().startswith("binary"):
                parts.append("  return 1.0 / (1.0 + std::exp(-PredictRaw(x)));")
            else:
                parts.append("  return PredictRaw(x);")
            parts.append("}")
        else:
            parts.append(f"static const int kNumClass = {k};")
            parts.append("extern \"C\" void PredictRaw(const double* x, double* out) {")
            for c in range(k):
                terms = " + ".join(
                    f"PredictTree{i}(x)" for i in range(c, len(trees), k)) or "0.0"
                parts.append(f"  out[{c}] = ({terms}) * {scale:.17g};")
            parts.append("}")
            parts.append("extern \"C\" void Predict(const double* x, double* out) {")
            parts.append("  PredictRaw(x, out);")
            parts.append("  double m = out[0]; for (int c = 1; c < kNumClass; ++c) "
                         "if (out[c] > m) m = out[c];")
            parts.append("  double s = 0.0; for (int c = 0; c < kNumClass; ++c) "
                         "{ out[c] = std::exp(out[c] - m); s += out[c]; }")
            parts.append("  for (int c = 0; c < kNumClass; ++c) out[c] /= s;")
            parts.append("}")
        return "\n".join(parts) + "\n"

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """reference: GBDT::FeatureImportance, over the first ``iteration``
        iterations (every iteration when None or <= 0)."""
        imp = np.zeros(len(self.feature_names), dtype=np.float64)
        trees = self.models
        if iteration is not None and iteration > 0:
            trees = trees[: iteration * self.num_tree_per_iteration]
        for t in trees:
            for i in range(t.num_internal):
                if importance_type == "split":
                    imp[t.split_feature[i]] += 1.0
                else:
                    imp[t.split_feature[i]] += max(float(t.split_gain[i]), 0.0)
        return imp

    # ------------------------------------------------------------------
    # model text format (reference: gbdt_model_text.cpp) — the JAX
    # package's writer and reader, so either package loads the other's text
    # ------------------------------------------------------------------
    def _objective_string(self) -> str:
        o = self.cfg.objective
        if o == "binary":
            return f"binary sigmoid:{self.cfg.sigmoid:g}"
        if o in ("multiclass", "multiclassova"):
            return f"{o} num_class:{self.cfg.num_class}"
        if o == "regression" and self.cfg.reg_sqrt:
            return "regression sqrt"
        return o

    def _trees_for_export(self, start: int, num_iteration: int,
                          fold: bool = True) -> List[Tree]:
        """The trees of iterations [start, start + num_iteration), with each
        class's init score folded into its first tree (reference:
        Tree::AddBias), so the saved model is self-contained; a random
        forest folds it into every tree, so the trees' mean carries it.
        ``fold=False``: the pure-delta trees (the snapshot form)."""
        k = self.num_tree_per_iteration
        lo = start * k
        hi = (len(self.models) if num_iteration < 0
              else min((start + num_iteration) * k, len(self.models)))
        trees = list(self.models[lo:hi])
        if not fold or lo != 0 or not any(s != 0.0 for s in self.init_scores):
            return trees
        for i in (range(len(trees)) if self.average_output
                  else range(min(k, len(trees)))):
            t = copy.deepcopy(trees[i])
            t.leaf_value = t.leaf_value + self.init_scores[i % k]
            t.internal_value = t.internal_value + self.init_scores[i % k]
            if t.is_linear and t.leaf_const is not None:
                # a linear leaf predicts from leaf_const, not leaf_value
                t.leaf_const = t.leaf_const + self.init_scores[i % k]
            trees[i] = t
        return trees

    def save_model_to_string(self, num_iteration: int = -1,
                             start_iteration: int = 0,
                             importance_type: Optional[str] = None,
                             raw_deltas: bool = False) -> str:
        """The model text.  ``raw_deltas``: the snapshot form of the JAX
        package: the trees stay pure deltas at full precision (%.17g) and
        the init scores ride an exact ``init_scores=`` header line, so a
        run resumed from it rebuilds the training score bitwise (folding
        rounds v0 + init in f64, which f32(init) + f32(v0) does not)."""
        if importance_type is None:
            importance_type = ("gain" if int(self.cfg.saved_feature_importance_type) == 1
                               else "split")
        trees = self._trees_for_export(start_iteration, num_iteration,
                                       fold=not raw_deltas)
        feature_names = self.feature_names
        if self.binner is not None:
            infos = []
            for m in self.binner.mappers:
                if m.is_trivial:
                    infos.append("none")
                elif m.is_categorical:
                    infos.append(":".join(str(int(c)) for c in m.categories))
                else:
                    infos.append(f"[{m.min_value:g}:{m.max_value:g}]")
        else:
            infos = ["none"] * len(feature_names)
        blocks = [t.to_string(i, precise=raw_deltas) for i, t in enumerate(trees)]
        lines = [
            "tree",
            f"version={_MODEL_VERSION}",
            f"num_class={self.cfg.num_class}",
            f"num_tree_per_iteration={self.num_tree_per_iteration}",
            "label_index=0",
            f"max_feature_idx={len(feature_names) - 1}",
            f"objective={self._objective_string()}",
            *(["average_output"] if self.average_output else []),
            *(["init_scores=" + " ".join(repr(float(v)) for v in self.init_scores)]
              if raw_deltas else []),
            "feature_names=" + " ".join(feature_names),
            "feature_infos=" + " ".join(infos),
            "tree_sizes=" + " ".join(str(len(b) + 1) for b in blocks),
            "",
        ]
        out = "\n".join(lines) + "\n" + "\n".join(blocks)
        out += "\nend of trees\n\n"
        imp = self.feature_importance(importance_type)
        out += "feature_importances:\n"
        for i in np.argsort(-imp, kind="stable"):
            if imp[i] > 0:
                out += f"{feature_names[i]}={imp[i]:g}\n"
        out += "\nparameters:\n"
        cfg = self.cfg.to_dict()
        for key in ("objective", "boosting", "num_iterations", "learning_rate",
                    "num_leaves", "max_depth", "min_data_in_leaf", "lambda_l1",
                    "lambda_l2", "max_bin", "num_class", "seed", "tree_learner",
                    "device_type"):
            out += f"[{key}: {cfg.get(key)}]\n"
        out += "end of parameters\n\npandas_categorical:null\n"
        return out

    @classmethod
    def load_model_from_string(cls, model_str: str,
                               device_type: str = "cuda") -> "GBDT":
        header, _, rest = model_str.partition("\nTree=")
        kv = {}
        for line in header.splitlines():
            if "=" in line:
                key, v = line.split("=", 1)
                kv[key.strip()] = v.strip()
        obj_str = kv.get("objective", "regression").split()
        params: Dict[str, object] = {"objective": obj_str[0],
                                     "device_type": device_type}
        for tok in obj_str[1:]:
            if ":" in tok:
                pk, pv = tok.split(":", 1)
                params[pk] = pv
            elif tok == "sqrt":  # reference: "regression sqrt"
                params["reg_sqrt"] = True
        if int(kv.get("num_class", 1)) > 1:
            params["num_class"] = int(kv["num_class"])
        booster = cls(Config.from_dict(params))
        booster.average_output = any(line.strip() == "average_output"
                                     for line in header.splitlines())
        booster.device = resolve_device(booster.cfg)
        booster.feature_names = kv.get("feature_names", "").split()
        k = booster.num_tree_per_iteration = int(kv.get("num_tree_per_iteration", 1))
        booster.init_scores = [0.0] * k  # folded into the trees
        if "init_scores" in kv:
            # raw-delta snapshot form: trees are pure deltas
            booster.init_scores = [float(v) for v in kv["init_scores"].split()]
        trees_part = rest.split("\nend of trees")[0]
        for b in ("Tree=" + trees_part).split("\nTree="):
            if b.strip():
                booster.models.append(
                    Tree.from_string(b if b.startswith("Tree=") else "Tree=" + b))
        booster.iter_ = len(booster.models) // max(k, 1)
        return booster


class DART(GBDT):
    """Dropout boosting (reference: src/boosting/dart.hpp; the JAX
    package's DART).  The drop draw is numpy's RandomState(drop_seed +
    iteration), so the dropped trees are the JAX package's.  Dropped trees
    leave every score before the iteration's gradients and come back
    rescaled after its trees, all on the device: a pending tree is rescaled
    by appending to its factors (``_scale_tree``), which export, predict
    and later drops read.  Unlike the JAX package, the validation scores
    follow the drops and rescales too, as LightGBM's DART::Normalize
    updates them, so they stay equal to the ensemble's prediction."""

    def train_one_iter(self, grad=None, hess=None) -> bool:
        cfg = self.cfg
        k = self.num_tree_per_iteration
        n_done = self.iter_
        rng = np.random.RandomState(cfg.drop_seed + n_done)
        drop: List[int] = []
        if n_done > 0 and rng.rand() >= cfg.skip_drop:
            if cfg.uniform_drop:
                drop = list(np.nonzero(rng.rand(n_done) < cfg.drop_rate)[0])
            else:
                want = max(int(round(n_done * cfg.drop_rate)), 1)
                drop = list(rng.choice(n_done, size=min(want, n_done), replace=False))
            drop = drop[: cfg.max_drop] if cfg.max_drop > 0 else drop
        self.drops.append(len(drop))
        sets = self._scored_sets()
        leaves = {}
        for it in drop:
            for c in range(k):
                i = int(it) * k + c
                vals = self._tree_leaf_values(i)
                for si, (ds, score) in enumerate(sets):
                    leaves[i, si] = self._tree_leaves(i, ds).long()
                    self._add_score(score, -vals[leaves[i, si]], c)
        finished = super().train_one_iter(grad, hess)
        if drop:
            n_drop = len(drop)
            if cfg.xgboost_dart_mode:
                new_scale = cfg.learning_rate / (n_drop + cfg.learning_rate)
                old_scale = n_drop / (n_drop + cfg.learning_rate)
            else:
                new_scale = 1.0 / (n_drop + 1.0)
                old_scale = n_drop / (n_drop + 1.0)
            new = [self._num_trees() - k + c for c in range(k)]
            for i in new:
                self._scale_tree(i, new_scale)
            for it in drop:
                for c in range(k):
                    self._scale_tree(int(it) * k + c, old_scale)
            for it in drop:
                for c in range(k):
                    i = int(it) * k + c
                    vals = self._tree_leaf_values(i)
                    for si, (_ds, score) in enumerate(sets):
                        self._add_score(score, vals[leaves[i, si]], c)
            # the scores hold the new trees unscaled: take the difference out
            corr = np.float32(1.0 / new_scale - 1.0)
            for c, i in enumerate(new):
                vals = self._tree_leaf_values(i)
                for ds, score in sets:
                    self._add_score(score, -(vals[self._tree_leaves(i, ds).long()] * corr), c)
        return finished


class RF(GBDT):
    """Random forest (reference: src/boosting/rf.hpp; the JAX package's
    RF): bagged trees on the gradients at the init score, shrinkage 1,
    predictions the trees' mean."""

    average_output = True

    def __init__(self, cfg: Config, train_set=None):
        if cfg.bagging_freq <= 0 or cfg.bagging_fraction >= 1.0:
            raise ValueError("Random forest needs bagging (bagging_freq > 0 and "
                             "bagging_fraction < 1)")
        super().__init__(cfg, train_set)

    def train_one_iter(self, grad=None, hess=None) -> bool:
        if grad is None and self.objective is not None:
            init = torch.as_tensor(np.asarray(self.init_scores, np.float32),
                                   device=self.device)
            base = torch.zeros_like(self._score) + (init[0] if self._score.dim() == 1
                                                    else init[None, :])
            grad, hess = self.objective.get_gradients(base, self._label, self._weight)
        return super().train_one_iter(grad, hess)

    def _eval_margin(self, score: torch.Tensor) -> torch.Tensor:
        # the score holds init + the sum of the trees; the metrics read
        # init + their mean
        init = torch.as_tensor(np.asarray(self.init_scores, np.float32),
                               device=self.device)
        init = init[0] if score.dim() == 1 else init[None, :]
        return init + (score - init) / max(self.iter_, 1)


def create_boosting(cfg: Config, train_set=None) -> GBDT:
    """reference: Boosting::CreateBoosting (src/boosting/boosting.cpp)."""
    name = cfg.boosting
    if name in ("gbdt", "gbrt", "goss"):
        if name == "goss":
            cfg.data_sample_strategy = "goss"
        return GBDT(cfg, train_set)
    if name == "dart":
        return DART(cfg, train_set)
    if name in ("rf", "random_forest"):
        return RF(cfg, train_set)
    raise ValueError(f"Unknown boosting type: {name}")


def _scaled(v: torch.Tensor, factors) -> torch.Tensor:
    """f32 of v times the factors in f64, as Tree.apply_shrinkage scales a
    host tree."""
    v = v.double()
    for f in factors:
        v = v * f
    return v.float()


def _leaves_of(xs: torch.Tensor, s: dict) -> torch.Tensor:
    """(N, T) i64: every tree's leaf for every row of ``xs``, from the
    stacked ensemble ``s`` (GBDT._stacked)."""
    s = {key: v for key, v in s.items() if key != "leaf_value"}
    return predict_ops.predict_leaf_values(xs, **s).long()


def _add_trees(trees: List[Tree], xs: torch.Tensor, leaves: torch.Tensor, lo: int,
               hi: int, k: int, out: torch.Tensor, tables=None) -> torch.Tensor:
    """``out`` (N, K) plus the values of trees [lo, hi) (tree i in class
    i % K), one after another: a linear tree's leaf models on the raw
    values, a constant tree's leaf values.  ``tables``: the trees'
    ``_linear_tables`` on the device already (a pack's).  In place;
    returns ``out``."""
    for i in range(lo, hi):
        linear = (_linear_tables(trees[i], xs.device) if tables is None
                  else tables[i])
        if linear is None:
            vals = torch.as_tensor(np.asarray(trees[i].leaf_value, np.float32),
                                   device=xs.device)[leaves[:, i]]
        else:
            vals = predict_linear_rows(xs, leaves[:, i], *linear)
        out[:, i % k] = out[:, i % k] + vals
    return out


def _linear_tables(tree: Tree, device) -> Optional[tuple]:
    """A host linear tree's leaf models as predict_linear_rows takes them
    (f32 on ``device``), or None for a constant tree."""
    if not tree.is_linear or tree.leaf_const is None:
        return None
    L = tree.num_leaves
    k = max([len(f) for f in tree.leaf_features] + [1])
    coef = np.zeros((L, k), np.float32)
    fidx = np.zeros((L, k), np.int32)
    nf = np.zeros(L, np.int32)
    for l in range(L):
        m = len(tree.leaf_features[l])
        nf[l] = m
        fidx[l, :m] = np.asarray(tree.leaf_features[l], np.int64)
        coef[l, :m] = np.asarray(tree.leaf_coeff[l], np.float64)
    return tuple(torch.as_tensor(a, device=device) for a in (
        coef, np.asarray(tree.leaf_const, np.float32), fidx, nf,
        np.asarray(tree.leaf_value, np.float32)))


def _walk_on(walk: dict, device) -> dict:
    """A pack's traversal tables (``_stacked``) copied to ``device``."""
    def to(v):
        if torch.is_tensor(v):
            return v.to(device)
        if isinstance(v, tuple):
            return tuple(to(x) for x in v)
        return v
    return {k: to(v) for k, v in walk.items()}


def _stacked_bitsets(trees: List[Tree], m: int, device) -> Optional[tuple]:
    """(is_cat, cat_base, cat_nwords) (T, m) and the flat bitset words (W,)
    of the trees' categorical nodes, or None when no tree has one."""
    if not any(t.num_cat > 0 for t in trees):
        return None
    is_cat = np.zeros((len(trees), m), bool)
    base = np.zeros((len(trees), m), np.int32)
    nwords = np.zeros((len(trees), m), np.int32)
    words, off = [], 0
    for i, t in enumerate(trees):
        nd = np.nonzero(t.is_categorical_node())[0]
        ci = np.asarray(t.threshold, np.float64)[nd].astype(np.int64)  # cat index
        bounds = np.asarray(t.cat_boundaries, np.int64)
        is_cat[i, nd] = True
        base[i, nd] = off + bounds[ci]
        nwords[i, nd] = bounds[ci + 1] - bounds[ci]
        words.append(np.asarray(t.cat_threshold, np.int64))
        off += len(t.cat_threshold)
    flat = np.concatenate(words) if off else np.zeros(1, np.int64)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (is_cat, base, nwords, flat))


def _pre_filter(bins: Optional[np.ndarray], binner, md: int, counts=None,
                n_rows: Optional[int] = None) -> np.ndarray:
    """feature_pre_filter (reference: DatasetLoader): drop numerical features
    that cannot produce a split satisfying min_data_in_leaf for any
    threshold or missing direction — an exact check on bin counts.
    ``counts``: each feature's bin counts, given instead of ``bins`` (a
    streamed matrix), with ``n_rows``."""
    nbpf = np.asarray(binner.num_bins_per_feature)
    mbpf = np.asarray(binner.missing_bin_per_feature)
    cat_mask = np.asarray(binner.categorical_mask)
    if bins is not None:
        n_rows = bins.shape[0]
    n_feat = len(nbpf)
    allowed = np.ones(n_feat, dtype=bool)
    for j in range(n_feat):
        if cat_mask[j] or nbpf[j] <= 1:
            continue
        cm = (np.bincount(bins[:, j].astype(np.int64), minlength=int(nbpf[j]))
              if counts is None else counts[j].copy())
        m = int(cm[mbpf[j]]) if mbpf[j] >= 0 else 0
        if mbpf[j] >= 0:
            cm[mbpf[j]] = 0
        p = np.cumsum(cm[: int(nbpf[j])])[:-1]  # left counts
        if p.size == 0:
            continue
        q = (n_rows - m) - p
        lo, hi = np.minimum(p, q), np.maximum(p, q)
        # the missing mass may join the smaller side
        if not np.any((hi >= md) & (lo + m >= md)):
            allowed[j] = False
    return allowed


def _class_init_scores(label: np.ndarray, weight, k: int) -> List[float]:
    """Each class's log-odds of its (weighted) share of the labels: the
    JAX package's multiclass init score (reference: BoostFromScore per
    tree id)."""
    out = []
    for c in range(k):
        lbl = (label == c).astype(np.float32)
        p = float(lbl.mean() if weight is None else np.average(lbl, weights=weight))
        p = min(max(p, 1e-15), 1 - 1e-15)
        out.append(float(np.log(p / (1 - p))))
    return out
