"""Training entry point.

Counterpart of lightgbm_tpu/engine.py::train (reference: engine.py train()).
Serving, continual training, fleets, cv, resume, tracing and checkpoints
are later queue items (ROADMAP queue A).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException
from .config import Config, choose_param_value
from .utils.log import log_info, set_verbosity


def train(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    valid_sets: Optional[List[Dataset]] = None,
    valid_names: Optional[List[str]] = None,
    callbacks: Optional[List[Callable]] = None,
) -> Booster:
    """Boost ``num_boost_round`` trees on ``train_set`` (on the card unless
    params say device_type='cpu')."""
    params = dict(params or {})
    params = choose_param_value("num_iterations", params, None)
    if params.get("num_iterations") is not None:
        num_boost_round = int(params["num_iterations"])
    params["num_iterations"] = num_boost_round
    params = choose_param_value("early_stopping_round", params, None)
    early_stopping_round = params.get("early_stopping_round")
    cfg = Config.from_dict(params)
    set_verbosity(cfg.verbosity)

    booster = Booster(params=params, train_set=train_set)
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
    for cb in callbacks:
        if not hasattr(cb, "order"):
            cb.order = 0  # type: ignore[attr-defined]
    before = sorted((cb for cb in callbacks if getattr(cb, "before_iteration", False)),
                    key=lambda cb: cb.order)
    after = sorted((cb for cb in callbacks if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: cb.order)
    train_in_valids = any(vs is train_set for vs in valid_sets)

    try:
        for i in range(num_boost_round):
            for cb in before:
                cb(CallbackEnv(booster, params, i, 0, num_boost_round, []))
            finished = booster.update()
            results = []
            if train_in_valids or cfg.is_provide_training_metric:
                results.extend(booster.eval_train())
            results.extend(booster.eval_valid())
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
