"""Gradient-boosting orchestration.

Counterpart of lightgbm_tpu/models/gbdt.py for the main path: single
device, serial tree learner, one tree per iteration, the round-batched
grower (ops/treegrow_fast.py).  Reference: src/boosting/gbdt.cpp
(GBDT::{Init,TrainOneIter}), gbdt_model_text.cpp (the `.txt` model).

Each iteration is an ordinary Python step on device tensors: gradients,
tree growth, and the score update `score += leaf_value[leaf_id] *
shrinkage`, which is a gather because the grower keeps every row's leaf id.
Trees stay device TreeArrays until something needs host trees
(save/predict), as in the JAX package.

Not ported yet, and rejected at construction: DART/RF/GOSS (queue A8),
multiclass (A4), the strict grower (A7), and the options of the grower
envelope that ops/treegrow_fast.py does not carry (A5/A8).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..metrics import Metric, create_metrics
from ..objectives import Objective, create_objective
from ..ops import predict as predict_ops
from ..ops.hist_cuda import recommended_leaf_tile
from ..ops.split import SplitParams
from ..ops.treegrow_fast import grow_tree_fast, predict_leaf_arrays
from .tree import Tree, tree_from_device

_MODEL_VERSION = "v4"


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


def _unported_options(cfg: Config) -> List[str]:
    """Config options outside this slice's envelope (they raise)."""
    checks = {
        "boosting": cfg.boosting not in ("gbdt", "gbrt"),
        "data_sample_strategy=goss": cfg.data_sample_strategy == "goss",
        "tree_learner": cfg.tree_learner != "serial",
        "tree_growth_mode=strict": cfg.tree_growth_mode == "strict",
        "hist_precision=bf16": cfg.hist_precision != "f32",
        "linear_tree": bool(cfg.linear_tree),
        "monotone_constraints": any(int(c) != 0 for c in
                                    (cfg.monotone_constraints or [])),
        "interaction_constraints": bool(cfg.interaction_constraints),
        "forcedsplits_filename": bool(cfg.forcedsplits_filename),
        "extra_trees": bool(cfg.extra_trees),
        "feature_fraction_bynode": cfg.feature_fraction_bynode < 1.0,
        "feature_contri": any(float(c) != 1.0 for c in
                              (cfg.feature_contri or [])),
        "cegb penalties": (cfg.cegb_penalty_split > 0 or any(
            p != 0 for p in (cfg.cegb_penalty_feature_coupled or [])
            + (cfg.cegb_penalty_feature_lazy or []))),
        "bagging_by_query": bool(cfg.bagging_by_query),
    }
    return [k for k, v in checks.items() if v]


class GBDT:
    """reference: class GBDT in src/boosting/gbdt.h."""

    def __init__(self, cfg: Config, train_set=None):
        self.cfg = cfg
        self.objective: Optional[Objective] = create_objective(cfg)
        self.train_set = None
        self._models: List[Tree] = []  # host trees
        self._pending: List[tuple] = []  # (device TreeArrays, shrinkage)
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
        self.device = torch.device("cpu")
        if train_set is not None:
            self.reset_training_data(train_set)

    # ------------------------------------------------------------------
    @property
    def models(self) -> List[Tree]:
        """Host trees; converts pending device trees first."""
        if self._pending:
            pending, self._pending = self._pending, []
            for arrays, shrink in pending:
                tree = tree_from_device(arrays.to_numpy(), self.binner)
                tree.apply_shrinkage(shrink)
                self._models.append(tree)
        return self._models

    @models.setter
    def models(self, value) -> None:
        self._pending = []
        self._models = value

    # ------------------------------------------------------------------
    def reset_training_data(self, train_set) -> None:
        """reference: GBDT::ResetTrainingData."""
        cfg = self.cfg
        bad = _unported_options(cfg)
        if self.num_tree_per_iteration != 1:
            bad.append("multiclass")
        if bad:
            raise ValueError(
                "not ported to lightgbm_tpu_torch yet: " + ", ".join(bad)
                + " (see ROADMAP queue A)")
        self.device = dev = resolve_device(cfg)
        self.train_set = train_set
        train_set.construct(device=dev)
        self.binner = train_set.binner
        self.feature_names = list(train_set.feature_names)
        self.metrics = create_metrics(cfg)
        n = train_set.num_data()
        self._label = torch.as_tensor(train_set.label, dtype=torch.float32,
                                      device=dev)
        self._weight = (None if train_set.weight is None else torch.as_tensor(
            train_set.weight, dtype=torch.float32, device=dev))
        init = torch.zeros(n, dtype=torch.float32, device=dev)
        if self.objective is not None:
            self.objective.prepare(np.asarray(train_set.label), train_set.weight)
            if cfg.boost_from_average and not self.models:
                self.init_scores = [self.objective.boost_from_score(
                    self._label, self._weight)]
                init += np.float32(self.init_scores[0])
        if train_set.init_score is not None:
            init += torch.as_tensor(np.asarray(train_set.init_score, np.float32)
                                    .reshape(n), device=dev)
        self._score = init
        self.reset_split_params()
        allowed = np.ones(train_set.num_feature(), dtype=bool)
        if cfg.feature_pre_filter and cfg.min_data_in_leaf > 1:
            allowed = _pre_filter(train_set.bins, train_set.binner,
                                  int(cfg.min_data_in_leaf))
        self._allowed_np = allowed
        self._allowed_features = torch.as_tensor(allowed, device=dev)
        self._leaf_tile = recommended_leaf_tile(
            train_set.max_num_bins, train_set.num_feature(), cfg.num_leaves,
            quantized=bool(cfg.use_quantized_grad))

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
        )

    def add_valid(self, valid_set, name: str) -> None:
        valid_set.construct(reference=self.train_set, device=self.device)
        self.valid_sets.append(valid_set)
        self.valid_names.append(name)
        n = valid_set.num_data()
        score = torch.zeros(n, dtype=torch.float32, device=self.device)
        if self.init_scores[0] != 0.0:
            score += np.float32(self.init_scores[0])
        if valid_set.init_score is not None:
            score += torch.as_tensor(np.asarray(valid_set.init_score, np.float32)
                                     .reshape(n), device=self.device)
        if self.models:
            raise NotImplementedError(
                "adding a validation set after training started is not "
                "ported yet (ROADMAP queue A8)")
        self._valid_scores.append(score)

    # ------------------------------------------------------------------
    def _bagging_mask(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Row selection for this iteration: (mask bool, weights f32)
        (reference: BaggingSampleStrategy, bagging.hpp)."""
        n = self.train_set.num_data()
        cfg = self.cfg
        dev = self.device
        use_bagging = cfg.bagging_freq > 0 and (
            cfg.bagging_fraction < 1.0
            or cfg.pos_bagging_fraction < 1.0
            or cfg.neg_bagging_fraction < 1.0
        )
        if not use_bagging:
            if self._last_mask is None:
                self._last_mask = (torch.ones(n, dtype=torch.bool, device=dev),
                                   torch.ones(n, dtype=torch.float32, device=dev))
            return self._last_mask
        if self._last_mask is not None and (self.iter_ % cfg.bagging_freq) != 0:
            return self._last_mask  # re-bag every bagging_freq iterations
        rng = np.random.RandomState(cfg.bagging_seed + self.iter_)
        if cfg.pos_bagging_fraction < 1.0 or cfg.neg_bagging_fraction < 1.0:
            lbl = np.asarray(self.train_set.label)
            mask = np.zeros(n, dtype=bool)
            pos = lbl > 0
            mask[pos] = rng.rand(int(pos.sum())) < cfg.pos_bagging_fraction
            mask[~pos] = rng.rand(int((~pos).sum())) < cfg.neg_bagging_fraction
        else:
            mask = rng.rand(n) < cfg.bagging_fraction
        self._last_mask = (torch.as_tensor(mask, device=dev),
                           torch.ones(n, dtype=torch.float32, device=dev))
        return self._last_mask

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

    # ------------------------------------------------------------------
    def train_one_iter(self) -> bool:
        """One boosting iteration (reference: GBDT::TrainOneIter).  Returns
        True when training cannot continue (the tree is a single leaf)."""
        ts = self.train_set
        cfg = self.cfg
        g, h = self.objective.get_gradients(self._score, self._label, self._weight)
        row_mask, sample_weight = self._bagging_mask()
        quant = bool(cfg.use_quantized_grad)
        gen = None
        if quant:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(cfg.seed * 1000003 + self.iter_ * 31)
        arrays, leaf_id = grow_tree_fast(
            ts.bins_device, g, h, row_mask, sample_weight, self._feature_mask(),
            ts.num_bins_pf_device, ts.missing_bin_pf_device,
            num_leaves=cfg.num_leaves,
            num_bins=ts.max_num_bins,
            max_depth=cfg.max_depth,
            params=self._split_params,
            leaf_tile=self._leaf_tile,
            quantize_bins=(cfg.num_grad_quant_bins if quant else 0),
            stochastic_rounding=bool(cfg.stochastic_rounding),
            quant_renew=bool(cfg.quant_train_renew_leaf),
            generator=gen,
        )
        shrinkage = cfg.learning_rate
        self._pending.append((arrays, shrinkage))
        delta = arrays.leaf_value * np.float32(shrinkage)
        self._score = self._score + delta[leaf_id.long()]
        for vi, vs in enumerate(self.valid_sets):
            leaf_v = predict_leaf_arrays(arrays, vs.bins_device,
                                         ts.missing_bin_pf_device)
            self._valid_scores[vi] = self._valid_scores[vi] + delta[leaf_v.long()]
        self.iter_ += 1
        return int(arrays.num_leaves) <= 1

    # ------------------------------------------------------------------
    def _converted(self, score: torch.Tensor) -> np.ndarray:
        if self.objective is not None:
            score = self.objective.convert_output(score)
        return score.cpu().numpy()

    def eval_at(self, data_idx: int) -> List[Tuple[str, str, float, bool]]:
        """data_idx 0 = training, 1.. = valid sets (reference:
        GBDT::GetEvalAt) -> (dataset_name, metric_name, value, higher_better)."""
        if data_idx == 0:
            ds, score, name = self.train_set, self._score, self.train_name
        else:
            ds = self.valid_sets[data_idx - 1]
            score = self._valid_scores[data_idx - 1]
            name = self.valid_names[data_idx - 1]
        pred = self._converted(score)
        label = np.asarray(ds.label)
        out = []
        for m in self.metrics:
            for mn, v, hib in m.eval(pred, label, ds.weight):
                out.append((name, mn, v, hib))
        return out

    # ------------------------------------------------------------------
    def _stacked(self, trees: List[Tree], device) -> Dict[str, torch.Tensor]:
        """Stacked structure-of-arrays ensemble for the traversal."""
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
        )

    def predict_raw(self, X: np.ndarray, start_iteration: int = 0,
                    num_iteration: int = -1) -> torch.Tensor:
        """Raw margins (N,) f32 on the device, from the export trees (init
        score folded into the first tree, as in a saved model), so an
        in-memory model and its text round-trip predict identically."""
        trees = self._trees_for_export(start_iteration, num_iteration)
        if any(t.num_cat > 0 or t.is_linear for t in trees):
            raise NotImplementedError("categorical / linear trees are not "
                                      "ported yet (ROADMAP queue A5/A8)")
        dev = self.device
        x = torch.as_tensor(np.asarray(X, np.float32), device=dev)
        if not trees:
            return torch.full((x.shape[0],), np.float32(self.init_scores[0]),
                              device=dev)
        s = self._stacked(trees, dev)
        # the traversal holds a few (trees, rows) int64 planes: cut the rows
        # so each plane stays near 2^25 elements (256 MiB)
        step = max(1, 2 ** 25 // len(trees))
        return torch.cat([predict_ops.predict_raw_values(x[i:i + step], **s)
                          for i in range(0, max(x.shape[0], 1), step)])

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: int = -1) -> np.ndarray:
        raw = self.predict_raw(X, start_iteration, num_iteration)
        if raw_score or self.objective is None:
            return raw.cpu().numpy().astype(np.float64)
        return self.objective.convert_output(raw).cpu().numpy()

    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        """reference: GBDT::FeatureImportance."""
        imp = np.zeros(len(self.feature_names), dtype=np.float64)
        for t in self.models:
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
        if o == "regression" and self.cfg.reg_sqrt:
            return "regression sqrt"
        return o

    def _trees_for_export(self, start: int, num_iteration: int) -> List[Tree]:
        """Trees with the init score folded into the first tree (reference:
        Tree::AddBias), so the saved model is self-contained."""
        hi = (len(self.models) if num_iteration < 0
              else min(start + num_iteration, len(self.models)))
        trees = list(self.models[start:hi])
        if start != 0 or self.init_scores[0] == 0.0 or not trees:
            return trees
        t = copy.deepcopy(trees[0])
        t.leaf_value = t.leaf_value + self.init_scores[0]
        t.internal_value = t.internal_value + self.init_scores[0]
        trees[0] = t
        return trees

    def save_model_to_string(self, num_iteration: int = -1,
                             start_iteration: int = 0,
                             importance_type: Optional[str] = None) -> str:
        if importance_type is None:
            importance_type = ("gain" if int(self.cfg.saved_feature_importance_type) == 1
                               else "split")
        trees = self._trees_for_export(start_iteration, num_iteration)
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
        blocks = [t.to_string(i) for i, t in enumerate(trees)]
        lines = [
            "tree",
            f"version={_MODEL_VERSION}",
            f"num_class={self.cfg.num_class}",
            f"num_tree_per_iteration={self.num_tree_per_iteration}",
            "label_index=0",
            f"max_feature_idx={len(feature_names) - 1}",
            f"objective={self._objective_string()}",
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
        if int(kv.get("num_class", 1)) > 1 or int(kv.get("num_tree_per_iteration", 1)) > 1:
            raise NotImplementedError("multiclass models are not ported yet "
                                      "(ROADMAP queue A4)")
        if any(line.strip() == "average_output" for line in header.splitlines()):
            raise NotImplementedError("random-forest models are not ported "
                                      "yet (ROADMAP queue A8)")
        booster = cls(Config.from_dict(params))
        booster.device = resolve_device(booster.cfg)
        booster.feature_names = kv.get("feature_names", "").split()
        if "init_scores" in kv:
            # raw-delta snapshot form: trees are pure deltas
            booster.init_scores = [float(v) for v in kv["init_scores"].split()]
        trees_part = rest.split("\nend of trees")[0]
        for b in ("Tree=" + trees_part).split("\nTree="):
            if b.strip():
                booster.models.append(
                    Tree.from_string(b if b.startswith("Tree=") else "Tree=" + b))
        booster.iter_ = len(booster.models)
        return booster


def _pre_filter(bins: np.ndarray, binner, md: int) -> np.ndarray:
    """feature_pre_filter (reference: DatasetLoader): drop numerical features
    that cannot produce a split satisfying min_data_in_leaf for any
    threshold or missing direction — an exact check on bin counts."""
    nbpf = np.asarray(binner.num_bins_per_feature)
    mbpf = np.asarray(binner.missing_bin_per_feature)
    cat_mask = np.asarray(binner.categorical_mask)
    n_rows, n_feat = bins.shape
    allowed = np.ones(n_feat, dtype=bool)
    for j in range(n_feat):
        if cat_mask[j] or nbpf[j] <= 1:
            continue
        cm = np.bincount(bins[:, j].astype(np.int64), minlength=int(nbpf[j]))
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
