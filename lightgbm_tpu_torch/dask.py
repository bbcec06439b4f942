"""Distributed sklearn-style estimators: the Dask module's analogue.

Counterpart of lightgbm_tpu/dask.py (reference: python-package/lightgbm/
dask.py, DaskLGBMClassifier / DaskLGBMRegressor / DaskLGBMRanker over dask
collections and a Client).  That module's job is orchestration: align
partitions to workers, open ports, build the ``machines`` list, run plain
training on every worker with the network parameters and return rank 0's
model as the matching estimator.  Here the estimators wrap
parallel/launcher.py::train_distributed: the workers are local processes
of a torch.distributed world, each given only its row shard
(``pre_partition``), and no dask package is needed.  ``fit`` takes numpy
arrays and array-likes instead of dask collections; the constructor
parameters, the predict surface and the fitted attributes are the local
estimators'.  ``eval_set`` is sharded like the training rows and its
metrics are taken over every rank's rows, so ``early_stopping_rounds``
stops every rank alike.
"""

from __future__ import annotations

import numpy as np

from .basic import LightGBMError
from .parallel.launcher import train_distributed
from .sklearn import LGBMClassifier, LGBMRanker, LGBMRegressor

__all__ = [
    "DaskLGBMClassifier",
    "DaskLGBMRegressor",
    "DaskLGBMRanker",
]


def _normalize_eval_set(eval_set):
    """One (X, y) tuple or a list of them -> list of (ndarray, 1-D ndarray)."""
    if eval_set is None:
        return None
    if isinstance(eval_set, tuple):
        eval_set = [eval_set]
    return [(np.asarray(Xe), np.asarray(ye).ravel()) for Xe, ye in eval_set]


class _DistributedFitMixin:
    """Shared distributed-fit plumbing (reference: dask.py _train).

    Declares the FULL LGBMModel parameter signature (sklearn's get_params
    introspects ``type(self).__init__`` — a bare ``**kwargs`` constructor
    would hide every training parameter from it, silently training with
    defaults; the reference's dask module re-declares the signature for
    the same reason), plus the two orchestration knobs."""

    def __init__(
        self,
        boosting_type: str = "gbdt",
        num_leaves: int = 31,
        max_depth: int = -1,
        learning_rate: float = 0.1,
        n_estimators: int = 100,
        subsample_for_bin: int = 200000,
        objective=None,
        class_weight=None,
        min_split_gain: float = 0.0,
        min_child_weight: float = 1e-3,
        min_child_samples: int = 20,
        subsample: float = 1.0,
        subsample_freq: int = 0,
        colsample_bytree: float = 1.0,
        reg_alpha: float = 0.0,
        reg_lambda: float = 0.0,
        random_state=None,
        n_jobs=None,
        importance_type: str = "split",
        num_machines: int = 2,
        launch_timeout_s: int = 600,
        **kwargs,
    ):
        self.num_machines = num_machines
        self.launch_timeout_s = launch_timeout_s
        super().__init__(
            boosting_type=boosting_type, num_leaves=num_leaves,
            max_depth=max_depth, learning_rate=learning_rate,
            n_estimators=n_estimators, subsample_for_bin=subsample_for_bin,
            objective=objective, class_weight=class_weight,
            min_split_gain=min_split_gain, min_child_weight=min_child_weight,
            min_child_samples=min_child_samples, subsample=subsample,
            subsample_freq=subsample_freq, colsample_bytree=colsample_bytree,
            reg_alpha=reg_alpha, reg_lambda=reg_lambda,
            random_state=random_state, n_jobs=n_jobs,
            importance_type=importance_type, **kwargs,
        )

    def _fit_distributed(self, X, y, sample_weight=None, group=None,
                         eval_set=None, eval_names=None,
                         eval_sample_weight=None, eval_group=None,
                         eval_metric=None, early_stopping_rounds=None):
        params = self._process_params(self._default_objective())
        if params.get("objective") == "none":
            raise LightGBMError(
                "custom objective callables are not supported by the "
                "distributed estimators (the objective must be "
                "reconstructable by name on every worker)")
        # estimator-orchestration params must not leak into training config
        for k in ("num_machines", "launch_timeout_s"):
            params.pop(k, None)
        if eval_metric is not None:
            if callable(eval_metric):
                raise LightGBMError(
                    "custom eval_metric callables are not supported by the "
                    "distributed estimators (metrics must be "
                    "reconstructable by name on every worker)")
            params["metric"] = eval_metric
        eval_set = _normalize_eval_set(eval_set)
        booster, _ = train_distributed(
            params,
            np.asarray(X),
            np.asarray(y).ravel(),
            self.n_estimators,
            num_machines=self.num_machines,
            weight=(None if sample_weight is None
                    else np.asarray(sample_weight, np.float64).ravel()),
            group=group,
            eval_set=eval_set,
            eval_names=eval_names,
            eval_weight=eval_sample_weight,
            eval_group=eval_group,
            early_stopping_rounds=early_stopping_rounds,
            timeout_s=self.launch_timeout_s,
        )
        self._Booster = booster
        self._fobj = None
        self._feval = None
        self._evals_result = getattr(booster, "_distributed_evals_result", {})
        self._n_features = booster.num_feature()
        self.n_features_in_ = self._n_features
        self.fitted_ = True
        self._best_iteration = booster.best_iteration
        self._best_score = booster.best_score
        return self


class DaskLGBMRegressor(_DistributedFitMixin, LGBMRegressor):
    """reference: dask.py DaskLGBMRegressor."""


    def fit(self, X, y, sample_weight=None, eval_set=None, eval_names=None,
            eval_sample_weight=None, eval_metric=None,
            early_stopping_rounds=None) -> "DaskLGBMRegressor":
        return self._fit_distributed(
            X, y, sample_weight=sample_weight, eval_set=eval_set,
            eval_names=eval_names, eval_sample_weight=eval_sample_weight,
            eval_metric=eval_metric,
            early_stopping_rounds=early_stopping_rounds)


class DaskLGBMClassifier(_DistributedFitMixin, LGBMClassifier):
    """reference: dask.py DaskLGBMClassifier."""


    def fit(self, X, y, sample_weight=None, eval_set=None, eval_names=None,
            eval_sample_weight=None, eval_metric=None,
            early_stopping_rounds=None) -> "DaskLGBMClassifier":
        y_enc = self._prepare_class_labels(y)
        if self.class_weight is not None and self.n_classes_ >= 2:
            # the local wrapper folds class_weight into sample weights
            # (LGBMModel.fit); mirror it here so the distributed model
            # matches rather than silently ignoring the option
            from sklearn.utils.class_weight import compute_sample_weight

            cw = compute_sample_weight(self.class_weight, y_enc)
            sample_weight = (cw if sample_weight is None
                             else np.asarray(sample_weight,
                                             np.float64).ravel() * cw)
        if eval_set is not None:
            eval_set = [(Xe, self._le.transform(ye))
                        for Xe, ye in _normalize_eval_set(eval_set)]
        return self._fit_distributed(
            X, y_enc, sample_weight=sample_weight, eval_set=eval_set,
            eval_names=eval_names, eval_sample_weight=eval_sample_weight,
            eval_metric=eval_metric,
            early_stopping_rounds=early_stopping_rounds)


class DaskLGBMRanker(_DistributedFitMixin, LGBMRanker):
    """reference: dask.py DaskLGBMRanker (group sizes required; shards snap
    to query boundaries — the launcher keeps queries whole per worker, as
    the reference keeps dask partitions whole)."""


    def fit(self, X, y, group=None, sample_weight=None, eval_set=None,
            eval_names=None, eval_sample_weight=None, eval_group=None,
            eval_metric=None, early_stopping_rounds=None,
            eval_at=(1, 2, 3, 4, 5)) -> "DaskLGBMRanker":
        if group is None:
            raise ValueError("Should set group for ranking task")
        if eval_set is not None and eval_group is None:
            raise ValueError(
                "eval_group must be provided with eval_set for ranking")
        self._other_params["eval_at"] = list(eval_at)
        setattr(self, "eval_at", list(eval_at))
        return self._fit_distributed(
            X, y, sample_weight=sample_weight,
            group=np.asarray(group, np.int64),
            eval_set=eval_set, eval_names=eval_names,
            eval_sample_weight=eval_sample_weight, eval_group=eval_group,
            eval_metric=eval_metric,
            early_stopping_rounds=early_stopping_rounds)
