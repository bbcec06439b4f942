"""Evaluation metrics (host, numpy).

Copy of the host path of lightgbm_tpu/metrics.py for the metrics this slice
serves: l2, rmse, l1, binary_logloss, binary_error and auc.  The others
raise NotImplementedError (ROADMAP queue A4).  Each metric returns
(name, value, is_higher_better), the tuple the eval framework hands to
callbacks.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .config import Config

EPS = 1e-15


def _auc(scores: np.ndarray, labels: np.ndarray, weights: Optional[np.ndarray]) -> float:
    """Weighted AUC via rank statistic (reference: AUCMetric in
    binary_metric.hpp — trapezoid over the weighted ROC)."""
    if weights is None:
        weights = np.ones_like(scores, dtype=np.float64)
    order = np.argsort(scores, kind="mergesort")
    s, y, w = scores[order], labels[order], weights[order]
    pos_w = np.where(y > 0, w, 0.0)
    neg_w = np.where(y > 0, 0.0, w)
    total_pos, total_neg = pos_w.sum(), neg_w.sum()
    if total_pos == 0 or total_neg == 0:
        return 1.0
    # For each positive, count negatives with lower score (+ half ties)
    _, inv = np.unique(s, return_inverse=True)
    grp_neg = np.bincount(inv, weights=neg_w)
    grp_pos = np.bincount(inv, weights=pos_w)
    cum_neg_before = np.concatenate([[0.0], np.cumsum(grp_neg)[:-1]])
    auc = np.sum(grp_pos * (cum_neg_before + 0.5 * grp_neg))
    return float(auc / (total_pos * total_neg))


class Metric:
    name: str = ""
    is_higher_better: bool = False

    def __init__(self, cfg: Config):
        self.cfg = cfg

    def eval(self, pred, label, weight) -> List[Tuple[str, float, bool]]:
        raise NotImplementedError


def _wmean(vals, weight):
    if weight is None:
        return float(np.mean(vals))
    return float(np.sum(vals * weight) / np.sum(weight))


class _Pointwise(Metric):
    def point(self, pred, label):
        raise NotImplementedError

    def transform(self, v: float) -> float:
        return v

    def eval(self, pred, label, weight):
        v = self.transform(_wmean(self.point(np.asarray(pred), np.asarray(label)), weight))
        return [(self.name, v, self.is_higher_better)]


class L2Metric(_Pointwise):
    name = "l2"

    def point(self, p, y):
        return (p - y) ** 2


class RMSEMetric(L2Metric):
    name = "rmse"

    def transform(self, v):
        return float(np.sqrt(v))


class L1Metric(_Pointwise):
    name = "l1"

    def point(self, p, y):
        return np.abs(p - y)


class BinaryLoglossMetric(_Pointwise):
    name = "binary_logloss"

    def point(self, p, y):
        p = np.clip(p, EPS, 1 - EPS)
        yy = (y > 0).astype(p.dtype)
        return -(yy * np.log(p) + (1 - yy) * np.log(1 - p))


class BinaryErrorMetric(_Pointwise):
    name = "binary_error"

    def point(self, p, y):
        return ((p > 0.5) != (y > 0)).astype(p.dtype)


class AUCMetric(Metric):
    name = "auc"
    is_higher_better = True

    def eval(self, pred, label, weight):
        return [(self.name, _auc(np.asarray(pred), np.asarray(label), weight), True)]


_METRICS = {
    "l2": L2Metric, "mse": L2Metric, "mean_squared_error": L2Metric,
    "regression": L2Metric, "regression_l2": L2Metric,
    "rmse": RMSEMetric, "root_mean_squared_error": RMSEMetric, "l2_root": RMSEMetric,
    "l1": L1Metric, "mae": L1Metric, "mean_absolute_error": L1Metric,
    "regression_l1": L1Metric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
}

_DEFAULT_METRIC_FOR_OBJECTIVE = {"regression": "l2", "binary": "binary_logloss"}


def create_metrics(cfg: Config) -> List[Metric]:
    """reference: Metric::CreateMetric + Config metric-default resolution."""
    names = list(cfg.metric)
    if not names:
        default = _DEFAULT_METRIC_FOR_OBJECTIVE.get(cfg.objective)
        names = [default] if default else []
    out = []
    for name in names:
        if str(name).lower() in ("none", "null", "na", "custom", ""):
            continue
        if name not in _METRICS:
            raise NotImplementedError(
                f"metric={name} is not ported to lightgbm_tpu_torch yet "
                "(ROADMAP queue A4)")
        out.append(_METRICS[name](cfg))
    return out
