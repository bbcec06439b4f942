"""FleetBooster: B independent boosters trained as one batch of lanes.

Counterpart of lightgbm_tpu/models/fleet.py (README "Booster fleets"):
per-tenant models over the same feature matrix, one binned Dataset, B
label (and weight) vectors, B independent models.  Each boosting iteration
computes every lane's gradients from its own objective, grows one tree a
lane with ops/treegrow_fleet.py (one CUDA-graph replay a fleet round under
fused_training, with B1 and B2 launched once a round in their lane mode)
and updates every lane's score.

Parity: every lane is bitwise the port's solo windowed run of the same
labels and weights (``train`` with tree_growth_mode=windowed and
megakernel=0: the three-pass windowed grower), model text and scores: the
gradients, the root pass, the rounds' arithmetic and the score update are
the solo run's operations on the lane's tensors, and the lane modes of B1
and B2 give each lane's solo results bit for bit.

Early stop is per lane and on the device: a lane past its ``rounds``
budget gets an all-False row mask, so it rides as a no-op lane (one leaf,
-0.0, an identity score update) and its trees past the budget are not
kept.

Lanes: ``booster(b)`` is a standard Booster over lane b (predict, save,
model text, serving); its GBDT holds the lane's trees as pending device
trees, read to the host at first use, and joins the pack-version protocol
like any model.  Lanes are serve and export only: they do not train on.

Envelope (``_check_envelope``, the JAX package's): one tree an iteration,
elementwise objectives without leaf renewal, gbdt boosting, no bagging or
GOSS, no feature sampling or extra_trees, no monotone, interaction or
forced splits, no linear trees, no categorical features, no EFB bundles,
no CEGB, one machine.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config, choose_param_value
from ..objectives import create_objective
from ..obs import metrics as _obs
from ..ops.graphs import RoundGraphs
from ..ops.treegrow_fleet import grow_fleet_windowed
from ..utils import sanitizer as _san
from ..utils.guards import NonFiniteError
from ..utils.log import set_verbosity
from .gbdt import GBDT

# objectives whose gradients are elementwise in (score, label, weight)
_FLEET_OBJECTIVES = (
    "RegressionL2", "RegressionHuber", "RegressionFair",
    "RegressionPoisson", "RegressionGamma", "RegressionTweedie",
    "BinaryLogloss", "CrossEntropy",
)


class FleetError(ValueError):
    """A configuration outside the fleet envelope (module docstring)."""


def _check_envelope(cfg: Config, proto: GBDT, train_set) -> None:
    bad: List[str] = []
    objective = proto.objective
    if cfg.num_tree_per_iteration != 1:
        bad.append("multiclass objectives (num_tree_per_iteration > 1)")
    if type(objective).__name__ not in _FLEET_OBJECTIVES:
        bad.append(f"objective {cfg.objective!r} (fleet gradients must be "
                   "elementwise; supported: regression/huber/fair/poisson/"
                   "gamma/tweedie/binary/cross_entropy)")
    if objective is not None and objective.need_renew:
        bad.append(f"objective {cfg.objective!r} needs leaf renewal")
    if proto.average_output or cfg.boosting not in ("gbdt",):
        bad.append(f"boosting={cfg.boosting!r} (gbdt only)")
    if cfg.data_sample_strategy == "goss":
        bad.append("GOSS sampling")
    if cfg.bagging_freq > 0 and (cfg.bagging_fraction < 1.0
                                 or cfg.pos_bagging_fraction < 1.0
                                 or cfg.neg_bagging_fraction < 1.0):
        bad.append("bagging")
    if (cfg.feature_fraction < 1.0 or cfg.feature_fraction_bynode < 1.0
            or proto._needs_node_rng):
        bad.append("feature sampling / extra_trees")
    if proto._monotone is not None:
        bad.append("monotone constraints")
    if proto._interaction_sets is not None:
        bad.append("interaction constraints")
    if proto._forced_schedule() is not None:
        bad.append("forced splits")
    if proto._linear:
        bad.append("linear trees")
    if proto._categorical_mask is not None:
        bad.append("categorical features")
    if getattr(train_set, "efb", None) is not None:
        bad.append("EFB bundles")
    if cfg.num_machines > 1:
        bad.append("multi-host runs")
    if proto._cegb_lazy is not None or proto._cegb_coupled is not None:
        bad.append("CEGB penalties")
    if getattr(train_set, "ooc_spill", False):
        bad.append("out-of-core spill datasets")
    if bad:
        raise FleetError(
            "train_fleet: configuration outside the fleet envelope: "
            + "; ".join(bad)
            + ". Train these models through train() instead "
            "(models/fleet.py module docstring).")


def _lane_inits(cfg: Config, labels: np.ndarray, weights, device):
    """Each lane's objective (prepared on its labels and weights), f32
    label and weight tensors and init score: the solo run's setup."""
    objs, lab_d, w_d, inits = [], [], [], []
    for b in range(labels.shape[0]):
        obj = create_objective(cfg)
        wb = None if weights is None else weights[b]
        obj.prepare(labels[b], wb)
        lab = torch.as_tensor(labels[b], dtype=torch.float32, device=device)
        w = (None if wb is None
             else torch.as_tensor(wb, dtype=torch.float32, device=device))
        init = float(obj.boost_from_score(lab, w)) if cfg.boost_from_average else 0.0
        objs.append(obj)
        lab_d.append(lab)
        w_d.append(w)
        inits.append(init)
    return objs, lab_d, w_d, inits


class FleetBooster:
    """B independent one-tree-an-iteration boosters over one shared binned
    Dataset.  ``labels`` is (B, N); ``weights`` optionally (B, N);
    ``rounds`` optionally each lane's budget of iterations.  Call
    :meth:`train` once, then :meth:`booster` / :meth:`boosters`."""

    def __init__(self, train_set, labels, params=None, *, weights=None,
                 rounds: Optional[Sequence[int]] = None):
        self.params = dict(params or {})
        self.cfg = Config.from_dict(dict(self.params))
        set_verbosity(self.cfg.verbosity)
        labels = np.asarray(labels, np.float64)
        if labels.ndim != 2 or labels.shape[0] < 1:
            raise FleetError(f"train_fleet: labels must be (B, N), got {labels.shape}")
        self.fleet_size, n = labels.shape
        if self.cfg.fleet_size and self.cfg.fleet_size != self.fleet_size:
            raise FleetError(f"train_fleet: fleet_size={self.cfg.fleet_size} does not "
                             f"match labels.shape[0]={self.fleet_size}")
        self._weights = None
        if weights is not None:
            self._weights = np.asarray(weights, np.float64)
            if self._weights.shape != labels.shape:
                raise FleetError(f"train_fleet: weights must match labels "
                                 f"{labels.shape}, got {self._weights.shape}")
        # lane 0's labels and weights are the shared Dataset's, so the
        # prototype GBDT derives every shared input as a solo run would
        # (split parameters, allowed features, leaf tile)
        train_set.set_field("label", labels[0])
        if self._weights is not None:
            train_set.set_field("weight", self._weights[0])
        merged = dict(train_set.params or {})
        merged.update(self.params)
        train_set.params = merged
        self._proto = GBDT(self.cfg, train_set)
        self.train_set = train_set
        self.device = self._proto.device
        self.binner = self._proto.binner
        self.feature_names = list(self._proto.feature_names)
        if train_set.num_data() != n:
            raise FleetError(f"train_fleet: labels are (B, {n}) but the dataset has "
                             f"{train_set.num_data()} rows")
        _check_envelope(self.cfg, self._proto, train_set)
        self._objectives, self._label_d, self._weight_d, self.init_scores = (
            _lane_inits(self.cfg, labels, self._weights, self.device))
        self._score = torch.stack([
            torch.zeros(n, dtype=torch.float32, device=self.device) + np.float32(i)
            for i in self.init_scores])
        self._bad = torch.zeros(self.fleet_size, dtype=torch.int32, device=self.device)
        if rounds is None:
            self._rounds = None  # filled by train()
        else:
            self._rounds = np.asarray(rounds, np.int64)
            if self._rounds.shape != (self.fleet_size,) or (self._rounds < 0).any():
                raise FleetError("train_fleet: rounds must be B non-negative per-lane "
                                 f"budgets, got {rounds!r}")
        self._iters: List[tuple] = []  # [(the lanes' TreeArrays, shrinkage)]
        self._lanes: dict = {}
        self.round_stats: List[dict] = []
        self._graphs: Optional[RoundGraphs] = None
        self._trained = False

    def train(self, num_boost_round: int = 100) -> "FleetBooster":
        """Train every lane ``num_boost_round`` iterations (a lane with a
        smaller budget stops early, on the device).  Once a fleet."""
        if self._trained:
            raise FleetError("train_fleet: a FleetBooster trains once")
        self._trained = True
        cfg, ts, proto = self.cfg, self.train_set, self._proto
        b = self.fleet_size
        if self._rounds is None:
            self._rounds = np.full((b,), int(num_boost_round), np.int64)
        num_boost_round = int(max(self._rounds.max(), 0))
        _obs.gauge("fleet_models").set(float(b))
        _obs.counter("train_fleet_models_total").inc(b)
        n = ts.num_data()
        dev = self.device
        ones = torch.ones((b, n), dtype=torch.float32, device=dev)
        quant = bool(cfg.use_quantized_grad)
        shrinkage = cfg.learning_rate
        if cfg.fused_training:
            self._graphs = RoundGraphs(dev)
        for it in range(num_boost_round):
            t0 = time.perf_counter()
            grads, hesses = zip(*[
                self._objectives[l].get_gradients(self._score[l], self._label_d[l],
                                                  self._weight_d[l])
                for l in range(b)])
            # per-lane budgets fold into the row mask: a finished lane is a
            # no-op lane, with no host branch per lane
            active = torch.as_tensor(self._rounds > it, device=dev)
            row_mask = active[:, None].expand(b, n).contiguous()
            stats: dict = {}
            trees, leaf_ids = grow_fleet_windowed(
                ts.bins_device, torch.stack(grads), torch.stack(hesses), row_mask, ones,
                proto._allowed_features, ts.num_bins_pf_device,
                ts.missing_bin_pf_device, num_leaves=cfg.num_leaves,
                num_bins=ts.max_num_bins, max_depth=cfg.max_depth,
                params=proto._split_params, leaf_tile=proto._leaf_tile,
                hist_precision=cfg.hist_precision,
                quantize_bins=cfg.num_grad_quant_bins if quant else 0,
                stochastic_rounding=bool(cfg.stochastic_rounding),
                quant_renew=bool(cfg.quant_train_renew_leaf),
                quant_seed=cfg.seed * 1000003 + it * 31, graphs=self._graphs,
                stats=stats, guard_label=f" (fleet iteration {it + 1})")
            for l, arrays in enumerate(trees):
                # the solo iteration's score update and non-finite guard
                delta = arrays.leaf_value * np.float32(shrinkage)
                self._score[l] += delta[leaf_ids[l].long()]
                ok = (torch.isfinite(arrays.leaf_value).all()
                      & ~torch.isnan(arrays.split_gain).any())
                self._bad[l] = torch.where((self._bad[l] == 0) & ~ok, it + 1,
                                           self._bad[l])
            self._iters.append((trees, shrinkage))
            self.round_stats.append(stats)
            _obs.event("fleet_round", models=b, iteration=it + 1,
                       rounds=stats.get("rounds"), dispatches=stats.get("dispatches"),
                       host_syncs=stats.get("host_syncs"), retries=stats.get("retries"),
                       ms=round((time.perf_counter() - t0) * 1e3, 3))
        return self

    def _guard_check(self) -> None:
        bad = _san.sync_pull(self._bad)
        if bad.any():
            lanes = np.nonzero(bad)[0].tolist()
            _obs.counter("train_nonfinite_errors_total").inc()
            _obs.event("nonfinite", phase="fleet_guard", lanes=lanes[:16],
                       iteration=int(bad[bad > 0].min()))
            raise NonFiniteError(
                f"non-finite leaf values entered fleet lane(s) {lanes[:16]} at "
                f"boosting iteration {int(bad[bad > 0].min())}; retrain the named "
                "lanes alone to find the offending labels")

    def _lane(self, b: int) -> "_FleetLane":
        if not 0 <= b < self.fleet_size:
            raise IndexError(f"fleet lane {b} out of range [0, {self.fleet_size})")
        lane = self._lanes.get(b)
        if lane is None:
            self._guard_check()
            lane = self._lanes[b] = _FleetLane(self, b)
        return lane

    def booster(self, b: int):
        """A standard Booster over lane ``b`` (predict, save_model, model
        text, serving, refit)."""
        from ..basic import Booster

        lane = self._lane(b)
        bst = Booster.__new__(Booster)
        bst.params = dict(lane.params)
        bst.best_iteration = -1
        bst.best_score = {}
        bst._train_set = self.train_set
        bst.cfg = lane.cfg
        bst._gbdt = lane
        return bst

    def boosters(self) -> List:
        return [self.booster(b) for b in range(self.fleet_size)]

    @property
    def num_iterations(self) -> np.ndarray:
        """Each lane's trained iteration count (its ``rounds`` budget)."""
        return (np.zeros(self.fleet_size, np.int64) if self._rounds is None
                else self._rounds.copy())


class _FleetLane(GBDT):
    """One fleet lane as a serve and export GBDT: its trees are pending
    device trees (read to the host at first use), so prediction, the model
    text and the pack-version protocol are the standard ones."""

    def __init__(self, fleet: FleetBooster, lane: int):
        # the lane's num_iterations is its own budget, as train() records it
        iters = min(int(fleet._rounds[lane]), len(fleet._iters))
        params = choose_param_value("num_iterations", dict(fleet.params), None)
        params["num_iterations"] = iters
        super().__init__(Config.from_dict(dict(params)), None)
        self.params, self.iter_ = params, iters
        self.objective = fleet._objectives[lane]
        self.device = fleet.device
        self.binner = fleet.binner
        self.feature_names = list(fleet.feature_names)
        self.init_scores = [fleet.init_scores[lane]]
        self._pending = [[trees[lane], [shrink], None]
                         for trees, shrink in fleet._iters[:self.iter_]]

    def train_one_iter(self, grad=None, hess=None) -> bool:
        raise FleetError("fleet lanes are serve and export only: grow the fleet "
                         "through train_fleet (refresh leaves: "
                         "continual.fleet_refit_leaves)")

