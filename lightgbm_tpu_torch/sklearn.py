"""scikit-learn estimator API.

Counterpart of lightgbm_tpu/sklearn.py (reference: python-package/lightgbm/
sklearn.py -- LGBMModel(BaseEstimator), LGBMClassifier/LGBMRegressor/
LGBMRanker, _ObjectiveFunctionWrapper / _EvalFunctionWrapper signature
adaptation, eval_set handling, fit params).  scikit-learn is optional: without
it the estimators keep working as plain classes, except LGBMClassifier's
label encoding and class weights, which need it.  Estimators train on the
card unless ``device_type='cpu'`` is passed.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from .basic import Booster, Dataset, LightGBMError
from .engine import train as _train

try:
    from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin
    from sklearn.preprocessing import LabelEncoder

    _SKLEARN = True
except ImportError:  # pragma: no cover
    _SKLEARN = False

    class BaseEstimator:  # type: ignore[no-redef]
        pass

    class ClassifierMixin:  # type: ignore[no-redef]
        pass

    class RegressorMixin:  # type: ignore[no-redef]
        pass


class _ObjectiveFunctionWrapper:
    """Adapt sklearn-signature fobj(y_true, y_pred[, weight, group]) to the
    engine's fobj(score, dataset) (reference: sklearn.py same class)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            return self.func(labels, preds)
        if argc == 3:
            return self.func(labels, preds, dataset.get_weight())
        return self.func(labels, preds, dataset.get_weight(), dataset.get_group())


class _EvalFunctionWrapper:
    """reference: sklearn.py _EvalFunctionWrapper."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            return self.func(labels, preds)
        if argc == 3:
            return self.func(labels, preds, dataset.get_weight())
        return self.func(labels, preds, dataset.get_weight(), dataset.get_group())


class LGBMModel(BaseEstimator):
    """reference: sklearn.py LGBMModel."""

    def __init__(
        self,
        boosting_type: str = "gbdt",
        num_leaves: int = 31,
        max_depth: int = -1,
        learning_rate: float = 0.1,
        n_estimators: int = 100,
        subsample_for_bin: int = 200000,
        objective: Optional[Union[str, Callable]] = None,
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
        n_jobs: Optional[int] = None,
        importance_type: str = "split",
        **kwargs,
    ):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self._other_params = dict(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)

    # -- params ----------------------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = super().get_params(deep=deep) if _SKLEARN else {}
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for k, v in params.items():
            setattr(self, k, v)
            if k not in self.__init__.__code__.co_varnames:
                self._other_params[k] = v
        return self

    def _process_params(self, default_objective: str) -> Dict[str, Any]:
        params = self.get_params()
        params.pop("importance_type", None)
        params.pop("n_estimators", None)
        params.pop("class_weight", None)
        obj = params.pop("objective", None)
        if callable(obj):
            self._fobj = _ObjectiveFunctionWrapper(obj)
            params["objective"] = "none"
        else:
            self._fobj = None
            params["objective"] = obj or default_objective
        ren = {
            "boosting_type": "boosting",
            "min_split_gain": "min_gain_to_split",
            "min_child_weight": "min_sum_hessian_in_leaf",
            "min_child_samples": "min_data_in_leaf",
            "subsample": "bagging_fraction",
            "subsample_freq": "bagging_freq",
            "colsample_bytree": "feature_fraction",
            "reg_alpha": "lambda_l1",
            "reg_lambda": "lambda_l2",
            "subsample_for_bin": "bin_construct_sample_cnt",
            "random_state": "seed",
            "n_jobs": "num_threads",
        }
        for old, new in ren.items():
            if old in params:
                v = params.pop(old)
                if v is not None:
                    params[new] = v
        if params.get("bagging_fraction", 1.0) < 1.0 and params.get("bagging_freq", 0) == 0:
            params["bagging_freq"] = 1
        if params.get("num_threads") is None:
            params.pop("num_threads", None)
        if params.get("seed") is None:
            params.pop("seed", None)
        params.setdefault("verbosity", -1)
        return params

    # -- fit --------------------------------------------------------------
    def fit(
        self,
        X,
        y,
        sample_weight=None,
        init_score=None,
        group=None,
        eval_set=None,
        eval_names=None,
        eval_sample_weight=None,
        eval_init_score=None,
        eval_group=None,
        eval_metric=None,
        feature_name="auto",
        categorical_feature="auto",
        callbacks=None,
        init_model=None,
    ) -> "LGBMModel":
        params = self._process_params(self._default_objective())
        if eval_metric is not None:
            if callable(eval_metric):
                self._feval = _EvalFunctionWrapper(eval_metric)
            else:
                self._feval = None
                params["metric"] = eval_metric if isinstance(eval_metric, list) else [eval_metric]
        else:
            self._feval = None

        y = np.asarray(y).ravel()
        sw = None if sample_weight is None else np.asarray(sample_weight, np.float64).ravel()
        if self.class_weight is not None and len(np.unique(y)) >= 2:
            from sklearn.utils.class_weight import compute_sample_weight

            cw = compute_sample_weight(self.class_weight, y)
            sw = cw if sw is None else sw * cw

        train_set = Dataset(
            X, label=y, weight=sw, group=group, init_score=init_score,
            feature_name=feature_name, categorical_feature=categorical_feature,
            params=params,
        )
        valid_sets = []
        valid_names = list(eval_names or [])
        if eval_set is not None:
            for i, (vx, vy) in enumerate(eval_set):
                vw = eval_sample_weight[i] if eval_sample_weight else None
                vis = eval_init_score[i] if eval_init_score else None
                vg = eval_group[i] if eval_group else None
                valid_sets.append(
                    Dataset(vx, label=np.asarray(vy).ravel(), weight=vw, group=vg,
                            init_score=vis, reference=train_set, params=params)
                )
                if i >= len(valid_names):
                    valid_names.append(f"valid_{i}")

        if self._fobj is not None:
            params["objective"] = self._fobj
        # record eval curves like the reference wrapper (sklearn.py:
        # LGBMModel.fit wires a record_evaluation callback -> evals_result_)
        self._evals_result = {}
        callbacks = list(callbacks) if callbacks else []
        if valid_sets:
            from .callback import record_evaluation

            callbacks.append(record_evaluation(self._evals_result))
        self._Booster = _train(
            params,
            train_set,
            num_boost_round=self.n_estimators,
            valid_sets=valid_sets,
            valid_names=valid_names,
            feval=self._feval,
            init_model=init_model,
            callbacks=callbacks,
        )
        self._n_features = train_set.num_feature()
        self.n_features_in_ = self._n_features
        self.fitted_ = True
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        return self

    def _default_objective(self) -> str:
        return "regression"

    # -- predict ----------------------------------------------------------
    def predict(self, X, raw_score=False, start_iteration=0, num_iteration=None,
                pred_leaf=False, pred_contrib=False, **kwargs):
        self._check_fitted()
        return self._Booster.predict(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf, pred_contrib=pred_contrib,
        )

    def _check_fitted(self):
        if not getattr(self, "fitted_", False):
            raise LightGBMError("Estimator not fitted, call fit before exploiting the model.")

    # -- properties --------------------------------------------------------
    @property
    def booster_(self) -> Booster:
        self._check_fitted()
        return self._Booster

    @property
    def best_iteration_(self) -> int:
        self._check_fitted()
        return self._best_iteration

    @property
    def best_score_(self):
        self._check_fitted()
        return self._best_score

    @property
    def evals_result_(self):
        self._check_fitted()
        return self._evals_result

    @property
    def feature_importances_(self) -> np.ndarray:
        self._check_fitted()
        return self._Booster.feature_importance(self.importance_type)

    @property
    def feature_name_(self) -> List[str]:
        self._check_fitted()
        return self._Booster.feature_name()

    @property
    def n_estimators_(self) -> int:
        self._check_fitted()
        return self._Booster.current_iteration()

    @property
    def n_iter_(self) -> int:
        self._check_fitted()
        return self._Booster.current_iteration()


class LGBMRegressor(RegressorMixin, LGBMModel):
    """reference: sklearn.py LGBMRegressor."""

    def _default_objective(self) -> str:
        return "regression"


class LGBMClassifier(ClassifierMixin, LGBMModel):
    """reference: sklearn.py LGBMClassifier (LabelEncoder + predict_proba)."""

    def _prepare_class_labels(self, y) -> np.ndarray:
        """Encode labels and resolve the classification objective; shared
        with the distributed estimators (dask.py)."""
        y = np.asarray(y).ravel()
        self._le = LabelEncoder().fit(y)
        y_enc = self._le.transform(y)
        self.classes_ = self._le.classes_
        self.n_classes_ = len(self.classes_)
        if self.n_classes_ > 2:
            if not callable(self.objective):
                obj = (self.objective
                       if isinstance(self.objective, str) else None)
                if obj is None or obj == "binary":
                    # binary cannot represent >2 classes — promote
                    # (reference wrapper: multiclass switch on n_classes);
                    # callable custom objectives are kept as-is
                    self.objective = "multiclass"
            self._other_params["num_class"] = self.n_classes_
            setattr(self, "num_class", self.n_classes_)
        return y_enc

    def fit(self, X, y, **kwargs) -> "LGBMClassifier":
        y_enc = self._prepare_class_labels(y)
        super().fit(X, y_enc, **kwargs)
        return self

    def _default_objective(self) -> str:
        return "multiclass" if getattr(self, "n_classes_", 2) > 2 else "binary"

    def predict_proba(self, X, raw_score=False, start_iteration=0, num_iteration=None, **kwargs):
        result = super().predict(X, raw_score=raw_score, start_iteration=start_iteration,
                                 num_iteration=num_iteration)
        if raw_score:
            return result
        if result.ndim == 1:
            return np.vstack([1.0 - result, result]).T
        return result

    def predict(self, X, raw_score=False, start_iteration=0, num_iteration=None,
                pred_leaf=False, pred_contrib=False, **kwargs):
        if raw_score or pred_leaf or pred_contrib:
            return super().predict(X, raw_score, start_iteration, num_iteration,
                                   pred_leaf, pred_contrib)
        proba = self.predict_proba(X, start_iteration=start_iteration, num_iteration=num_iteration)
        idx = np.argmax(proba, axis=1)
        return self._le.inverse_transform(idx)


class LGBMRanker(LGBMModel):
    """reference: sklearn.py LGBMRanker (group/eval_group required)."""

    def _default_objective(self) -> str:
        return "lambdarank"

    def fit(self, X, y, group=None, eval_group=None, eval_at=(1, 2, 3, 4, 5), **kwargs) -> "LGBMRanker":
        if group is None:
            raise ValueError("Should set group for ranking task")
        if kwargs.get("eval_set") is not None and eval_group is None:
            raise ValueError("Eval_group cannot be None when eval_set is not None")
        self._other_params["eval_at"] = list(eval_at)
        setattr(self, "eval_at", list(eval_at))
        super().fit(X, y, group=group, eval_group=eval_group, **kwargs)
        return self
