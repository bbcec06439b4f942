"""Training callbacks.

Copy of lightgbm_tpu/callback.py (stdlib only); reset_parameter goes
through Booster.reset_parameter.

Reference: python-package/lightgbm/callback.py — CallbackEnv,
log_evaluation, record_evaluation, reset_parameter, early_stopping
(class-based stateful implementation), EarlyStopException, callback
`.order` / `.before_iteration` ordering contract.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .utils.log import log_info, log_warning


class EarlyStopException(Exception):
    """reference: EarlyStopException(best_iteration, best_score)."""

    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


@dataclass
class CallbackEnv:
    model: Any
    params: Dict[str, Any]
    iteration: int
    begin_iteration: int
    end_iteration: int
    evaluation_result_list: List[Tuple[str, str, float, bool]]


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """reference: callback.log_evaluation."""

    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list and (env.iteration + 1) % period == 0:
            result = "\t".join(
                _format_eval_result(x, show_stdv) for x in env.evaluation_result_list
            )
            log_info(f"[{env.iteration + 1}]\t{result}")

    _callback.order = 10  # type: ignore[attr-defined]
    _callback.before_iteration = False  # type: ignore[attr-defined]
    return _callback


def _format_eval_result(value, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    # cv result with stdv
    if show_stdv:
        return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
    return f"{value[0]}'s {value[1]}: {value[2]:g}"


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]) -> Callable:
    """reference: callback.record_evaluation."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for item in env.evaluation_result_list:
            name, metric = item[0], item[1]
            eval_result.setdefault(name, {}).setdefault(metric, [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for item in env.evaluation_result_list:
            name, metric, val = item[0], item[1], item[2]
            eval_result.setdefault(name, {}).setdefault(metric, []).append(val)
            if len(item) >= 5:  # cv stdv
                eval_result[name].setdefault(f"{metric}-stdv", []).append(item[4])

    _callback.order = 20  # type: ignore[attr-defined]
    _callback.before_iteration = False  # type: ignore[attr-defined]
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """Per-iteration parameter schedules (reference: callback.reset_parameter).
    Values may be lists (indexed by iteration) or callables iteration->value."""

    def _callback(env: CallbackEnv) -> None:
        new_params = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(f"Length of list {key!r} has to equal to 'num_boost_round'.")
                new_param = value[env.iteration - env.begin_iteration]
            else:
                new_param = value(env.iteration - env.begin_iteration)
            new_params[key] = new_param
        if new_params:
            env.model.reset_parameter(new_params)
            env.params.update(new_params)

    _callback.before_iteration = True  # type: ignore[attr-defined]
    _callback.order = 10  # type: ignore[attr-defined]
    return _callback


class _EarlyStoppingCallback:
    """reference: callback._EarlyStoppingCallback."""

    def __init__(self, stopping_rounds: int, first_metric_only: bool = False,
                 verbose: bool = True, min_delta: float = 0.0):
        if stopping_rounds <= 0:
            raise ValueError("stopping_rounds should be greater than zero.")
        self.stopping_rounds = stopping_rounds
        self.first_metric_only = first_metric_only
        self.verbose = verbose
        self.min_delta = min_delta
        self.order = 30
        self.before_iteration = False
        self.enabled = True
        self._reset_storages()

    def _reset_storages(self) -> None:
        self.best_score: List[float] = []
        self.best_iter: List[int] = []
        self.best_score_list: List[Any] = []
        self.cmp_op: List[Callable[[float, float], bool]] = []
        self.first_metric = ""
        self._initialized = False

    def _init(self, env: CallbackEnv) -> None:
        self._initialized = True
        if not env.evaluation_result_list:
            self.enabled = False
            log_warning("Early stopping is only available if at least one validation set is provided.")
            return
        if self.verbose:
            log_info(f"Training until validation scores don't improve for {self.stopping_rounds} rounds")
        self.first_metric = env.evaluation_result_list[0][1]
        for item in env.evaluation_result_list:
            higher_better = item[3]
            self.best_iter.append(0)
            if higher_better:
                self.best_score.append(float("-inf"))
                self.cmp_op.append(lambda cur, best: cur > best + self.min_delta)
            else:
                self.best_score.append(float("inf"))
                self.cmp_op.append(lambda cur, best: cur < best - self.min_delta)
            self.best_score_list.append(None)

    def __call__(self, env: CallbackEnv) -> None:
        if not self._initialized:
            self._init(env)
        if not self.enabled:
            return
        # skip the training-set entries (reference: early stopping only
        # watches validation sets unless only train is available)
        for i, item in enumerate(env.evaluation_result_list):
            name, metric, score = item[0], item[1], item[2]
            if self.best_score_list[i] is None or self.cmp_op[i](score, self.best_score[i]):
                self.best_score[i] = score
                self.best_iter[i] = env.iteration
                self.best_score_list[i] = env.evaluation_result_list
            if self.first_metric_only and metric != self.first_metric:
                continue
            if name == "training":
                continue
            if env.iteration - self.best_iter[i] >= self.stopping_rounds:
                if self.verbose:
                    log_info(
                        f"Early stopping, best iteration is:\n[{self.best_iter[i] + 1}]\t"
                        + "\t".join(_format_eval_result(x) for x in self.best_score_list[i])
                    )
                raise EarlyStopException(self.best_iter[i], self.best_score_list[i])
            if env.iteration == env.end_iteration - 1:
                if self.verbose:
                    log_info(
                        f"Did not meet early stopping. Best iteration is:\n[{self.best_iter[i] + 1}]\t"
                        + "\t".join(_format_eval_result(x) for x in self.best_score_list[i])
                    )
                raise EarlyStopException(self.best_iter[i], self.best_score_list[i])


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta: float = 0.0) -> _EarlyStoppingCallback:
    """reference: callback.early_stopping."""
    return _EarlyStoppingCallback(stopping_rounds, first_metric_only, verbose, min_delta)
