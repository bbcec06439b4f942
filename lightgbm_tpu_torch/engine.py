"""Training entry points: train() and cv().

Counterpart of lightgbm_tpu/engine.py::train and ::cv (reference:
python-package/lightgbm/engine.py: train(), cv(), CVBooster, callback
ordering by ``.order`` / ``.before_iteration``, the EarlyStopException
flow).  Resuming from checkpoints (``resume=``, snapshot families) waits
for utils/checkpoint.py (ROADMAP queue A14); serving, continual training
and fleets are later queue items too.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException
from .config import Config, choose_param_value
from .utils.log import log_info, set_verbosity


def _load_init_booster(init_model, device_type: str) -> Booster:
    """init_model as a Booster: a Booster, a model file or a model string
    (loaded for ``device_type``).  Snapshot files (``*.snapshot_iter_<k>``,
    verified and replaced by an older valid one in the JAX package) wait
    for the checkpoint module."""
    if isinstance(init_model, Booster):
        return init_model
    text = os.fspath(init_model)
    params = {"device_type": device_type}
    if text.startswith("tree\n"):
        return Booster(params=params, model_str=text)
    if ".snapshot_iter_" in os.path.basename(text):
        raise NotImplementedError("init_model from a checkpoint snapshot is not "
                                  "ported to lightgbm_tpu_torch yet (ROADMAP queue A14)")
    return Booster(params=params, model_file=text)


def _replay_scores(gbdt) -> None:
    """The training score from the trees so far (continued training): each
    tree's f32 leaf values added in training order, on the device."""
    k = gbdt.num_tree_per_iteration
    for i in range(gbdt._num_trees()):
        gbdt._add_score(gbdt._score, gbdt._tree_rows(i, gbdt.train_set), i % k)


def _seed_from(booster: Booster, init_model) -> None:
    """Start ``booster``'s training from ``init_model``'s trees (the JAX
    package's train(init_model=)): the trees and iteration count are
    carried over, and the score is rebuilt from the init scores, the
    training set's init_score and the trees in training order."""
    gbdt = booster._gbdt
    src = _load_init_booster(init_model, gbdt.cfg.device_type)._gbdt
    k = gbdt.num_tree_per_iteration
    if src.average_output:
        # a forest's text folds its init into every tree
        from .models.gbdt import GBDT

        gbdt.models = GBDT.load_model_from_string(
            src.save_model_to_string(), gbdt.cfg.device_type).models
        gbdt.init_scores = [0.0] * k
    else:
        gbdt.models = copy.deepcopy(src.models)
        gbdt.init_scores = list(src.init_scores)
    gbdt.iter_ = len(gbdt.models) // max(k, 1)
    base = np.zeros(tuple(gbdt._score.shape), dtype=np.float32)
    if any(s != 0.0 for s in gbdt.init_scores):
        base += (np.float32(gbdt.init_scores[0]) if k == 1
                 else np.asarray(gbdt.init_scores, dtype=np.float32)[None, :])
    ts = gbdt.train_set
    if ts.init_score is not None:
        base += np.asarray(ts.init_score, np.float32).reshape(base.shape)
    gbdt._score = torch.as_tensor(base, device=gbdt.device)
    _replay_scores(gbdt)


def _ordered(callbacks) -> tuple:
    """(before-iteration, after-iteration) callbacks, each sorted by order."""
    for cb in callbacks:
        if not hasattr(cb, "order"):
            cb.order = 0  # type: ignore[attr-defined]
    before = sorted((cb for cb in callbacks if getattr(cb, "before_iteration", False)),
                    key=lambda cb: cb.order)
    after = sorted((cb for cb in callbacks if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: cb.order)
    return before, after


def train(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    valid_sets: Optional[List[Dataset]] = None,
    valid_names: Optional[List[str]] = None,
    feval: Optional[Callable] = None,
    init_model: Optional[Union[str, Booster]] = None,
    keep_training_booster: bool = False,
    callbacks: Optional[List[Callable]] = None,
    resume: Optional[str] = None,
) -> Booster:
    """Boost ``num_boost_round`` iterations on ``train_set`` (on the card
    unless params say device_type='cpu').  ``feval(score, dataset)`` adds
    metrics; ``init_model`` (a Booster, a model file or a model string)
    continues its trees; a callable ``objective`` gives the gradients.
    The returned booster keeps its training state whatever
    ``keep_training_booster`` says, as in the JAX package."""
    params = dict(params or {})
    params = choose_param_value("num_iterations", params, None)
    if params.get("num_iterations") is not None:
        num_boost_round = int(params["num_iterations"])
    params["num_iterations"] = num_boost_round
    params = choose_param_value("early_stopping_round", params, None)
    early_stopping_round = params.get("early_stopping_round")
    fobj = None
    if callable(params.get("objective")):
        fobj = params["objective"]
        params["objective"] = "none"
    cfg = Config.from_dict(params)
    set_verbosity(cfg.verbosity)
    if resume is not None or cfg.resume:
        raise NotImplementedError("resume= (checkpoint snapshots) is not ported to "
                                  "lightgbm_tpu_torch yet (ROADMAP queue A14)")

    booster = Booster(params=params, train_set=train_set)
    if init_model is not None:
        _seed_from(booster, init_model)
    valid_sets = valid_sets or []
    valid_names = valid_names or []
    for i, vs in enumerate(valid_sets):
        if vs is train_set:
            booster._gbdt.train_name = (valid_names[i] if i < len(valid_names)
                                        else "training")
            continue
        booster.add_valid(vs, valid_names[i] if i < len(valid_names)
                          else f"valid_{i}")

    callbacks = list(callbacks or [])
    if early_stopping_round is not None and int(early_stopping_round) > 0:
        from .callback import early_stopping

        callbacks.append(early_stopping(
            int(early_stopping_round),
            first_metric_only=bool(params.get("first_metric_only", False)),
            verbose=cfg.verbosity >= 1,
            min_delta=float(params.get("early_stopping_min_delta", 0.0))))
    before, after = _ordered(callbacks)
    train_in_valids = any(vs is train_set for vs in valid_sets)

    try:
        for i in range(num_boost_round):
            for cb in before:
                cb(CallbackEnv(booster, params, i, 0, num_boost_round, []))
            finished = booster.update(fobj=fobj)
            results = []
            if train_in_valids or booster._gbdt.cfg.is_provide_training_metric:
                results.extend(booster.eval_train(feval))
            results.extend(booster.eval_valid(feval))
            for cb in after:
                cb(CallbackEnv(booster, params, i, 0, num_boost_round, results))
            if finished:
                log_info("Stopped training because there are no more leaves "
                         "that meet the split requirements")
                break
    except EarlyStopException as e:
        booster.best_iteration = e.best_iteration + 1
        for item in e.best_score:
            booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
    return booster


class CVBooster:
    """The folds' boosters of cv(); a method call on it calls every fold's
    booster and returns the list of results (reference: CVBooster)."""

    def __init__(self, boosters: Optional[List[Booster]] = None):
        self.boosters = boosters or []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]

        return handler_function


def _make_n_folds(full_data: Dataset, nfold: int, params: Dict, seed: int,
                  stratified: bool, shuffle: bool):
    """(train rows, test rows) of each fold, from numpy's RandomState(seed):
    whole queries for ranking data, stratified by label when asked."""
    num_data = full_data.num_data()
    rng = np.random.RandomState(seed)
    if full_data.group is not None:
        qidx = np.arange(len(full_data.group))
        if shuffle:
            rng.shuffle(qidx)
        bounds = np.concatenate([[0], np.cumsum(full_data.group)]).astype(np.int64)
        for q_chunk in np.array_split(qidx, nfold):
            te = np.sort(np.concatenate([np.arange(bounds[q], bounds[q + 1])
                                         for q in q_chunk]))
            yield np.setdiff1d(np.arange(num_data), te), te
        return
    if stratified and full_data.label is not None:
        label = np.asarray(full_data.label)
        folds: List[list] = [[] for _ in range(nfold)]
        for c in np.unique(label):
            idx = np.nonzero(label == c)[0]
            if shuffle:
                rng.shuffle(idx)
            for i, chunk in enumerate(np.array_split(idx, nfold)):
                folds[i].extend(chunk.tolist())
        test_indices = [np.asarray(sorted(f), dtype=np.int64) for f in folds]
    else:
        idx = np.arange(num_data)
        if shuffle:
            rng.shuffle(idx)
        test_indices = [np.sort(chunk) for chunk in np.array_split(idx, nfold)]
    for te in test_indices:
        yield np.setdiff1d(np.arange(num_data), te), te


def cv(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    folds=None,
    nfold: int = 5,
    stratified: bool = True,
    shuffle: bool = True,
    metrics=None,
    feval=None,
    init_model=None,
    fpreproc=None,
    seed: int = 0,
    callbacks=None,
    eval_train_metric: bool = False,
    return_cvbooster: bool = False,
) -> Dict[str, Any]:
    """K-fold cross-validation (reference: engine.py cv()): per iteration,
    the mean and standard deviation over the folds of each validation
    metric, under "<set> <metric>-mean" / "-stdv".  ``init_model`` and
    ``fpreproc`` are accepted and unused, as in the JAX package."""
    from .models.gbdt import resolve_device

    params = dict(params or {})
    if metrics is not None:
        params["metric"] = metrics
    params = choose_param_value("num_iterations", params, None)
    if params.get("num_iterations") is not None:
        num_boost_round = int(params["num_iterations"])
    params.pop("num_iterations", None)
    params = choose_param_value("early_stopping_round", params, None)
    early_stopping_round = params.get("early_stopping_round")
    objective = params.get("objective", "")
    stratified = stratified and isinstance(objective, str) and (
        objective.startswith("binary") or objective.startswith("multiclass"))

    train_set.construct(device=resolve_device(Config.from_dict(
        {**(train_set.params or {}), **params})))
    if folds is None:
        folds = list(_make_n_folds(train_set, nfold, params, seed, stratified, shuffle))
    elif hasattr(folds, "split"):
        folds = list(folds.split(np.zeros(train_set.num_data()),
                                 np.asarray(train_set.label)))

    cvbooster = CVBooster()
    for tr_idx, te_idx in folds:
        bst = Booster(params=params, train_set=train_set.subset(tr_idx))
        bst.add_valid(train_set.subset(te_idx), "valid")
        cvbooster.append(bst)

    callbacks = list(callbacks or [])
    if early_stopping_round is not None and int(early_stopping_round) > 0:
        from .callback import early_stopping

        callbacks.append(early_stopping(int(early_stopping_round), verbose=False))
    before, after = _ordered(callbacks)

    results: Dict[str, List[float]] = {}
    try:
        for i in range(num_boost_round):
            for cb in before:
                cb(CallbackEnv(cvbooster, params, i, 0, num_boost_round, []))
            merged: Dict[tuple, List[float]] = {}
            for bst in cvbooster.boosters:
                bst.update()
                evals = bst.eval_valid(feval)
                if eval_train_metric:
                    evals = bst.eval_train(feval) + evals
                for (name, metric, val, hib) in evals:
                    merged.setdefault((name, metric, hib), []).append(val)
            agg = []
            for (name, metric, hib), vals in merged.items():
                mean, std = float(np.mean(vals)), float(np.std(vals))
                results.setdefault(f"{name} {metric}-mean", []).append(mean)
                results.setdefault(f"{name} {metric}-stdv", []).append(std)
                agg.append((name, metric, mean, hib, std))
            for cb in after:
                cb(CallbackEnv(cvbooster, params, i, 0, num_boost_round, agg))
    except EarlyStopException as e:
        cvbooster.best_iteration = e.best_iteration + 1
        for key in list(results.keys()):
            results[key] = results[key][: cvbooster.best_iteration]
    if return_cvbooster:
        results["cvbooster"] = cvbooster  # type: ignore[assignment]
    return results
