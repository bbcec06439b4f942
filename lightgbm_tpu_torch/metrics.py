"""Evaluation metrics (host, numpy).

Copy of the host path of lightgbm_tpu/metrics.py, every metric of its
create_metrics (reference: src/metric/ and Metric::CreateMetric).  The JAX
package also evaluates some metrics inside a jit on its device; here every
metric runs on the host on the converted scores.  Each metric returns
(name, value, is_higher_better), the tuple the eval framework hands to
callbacks; the ranking metrics read the dataset's query boundaries.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .config import Config

EPS = 1e-15


def dcg_at_k(labels_sorted_desc: np.ndarray, k: int, label_gain: np.ndarray) -> float:
    """DCG of the given label order truncated at k (reference:
    DCGCalculator::CalDCGAtK in src/metric/dcg_calculator.cpp)."""
    k = min(k, len(labels_sorted_desc))
    if k <= 0:
        return 0.0
    lab = np.clip(labels_sorted_desc[:k].astype(np.int64), 0, len(label_gain) - 1)
    gains = label_gain[lab]
    discounts = 1.0 / np.log2(np.arange(k, dtype=np.float64) + 2.0)
    return float(np.sum(gains * discounts))


def ndcg_at_k(scores, labels, query_boundaries, k, label_gain) -> float:
    """Mean per-query NDCG@k (reference: NDCGMetric::Eval)."""
    nq = len(query_boundaries) - 1
    total, cnt = 0.0, 0
    for q in range(nq):
        lo, hi = query_boundaries[q], query_boundaries[q + 1]
        ql, qs = labels[lo:hi], scores[lo:hi]
        if np.all(ql == ql[0]):
            total += 1.0  # reference: queries w/o label variation count as 1
            cnt += 1
            continue
        order = np.argsort(-qs, kind="stable")
        d = dcg_at_k(ql[order], k, label_gain)
        ideal = dcg_at_k(np.sort(ql)[::-1], k, label_gain)
        total += d / ideal if ideal > 0 else 1.0
        cnt += 1
    return total / max(cnt, 1)


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

    def eval(self, pred, label, weight,
             query_boundaries=None) -> List[Tuple[str, float, bool]]:
        raise NotImplementedError


def _wmean(vals, weight):
    if weight is None:
        return float(np.mean(vals))
    return float(np.sum(vals * weight) / np.sum(weight))


class _Pointwise(Metric):
    def point(self, p, y):
        raise NotImplementedError

    def transform(self, v: float) -> float:
        return v

    def eval(self, pred, label, weight, query_boundaries=None):
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


class QuantileMetric(_Pointwise):
    name = "quantile"

    def point(self, p, y):
        a = self.cfg.alpha
        d = y - p
        return np.where(d >= 0, a * d, (a - 1.0) * d)


class HuberMetric(_Pointwise):
    name = "huber"

    def point(self, p, y):
        a = self.cfg.alpha
        d = np.abs(p - y)
        return np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


class FairMetric(_Pointwise):
    name = "fair"

    def point(self, p, y):
        c = self.cfg.fair_c
        x = np.abs(p - y)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_Pointwise):
    name = "poisson"

    def point(self, p, y):
        return p - y * np.log(np.maximum(p, 1e-10))


class GammaMetric(_Pointwise):
    name = "gamma"

    def point(self, p, y):
        x = np.maximum(p, 1e-10)
        return y / x + np.log(x)


class GammaDevianceMetric(_Pointwise):
    name = "gamma_deviance"

    def point(self, p, y):
        eps = 1e-10
        r = y / np.maximum(p, eps)
        return 2.0 * (np.log(np.maximum(1.0 / np.maximum(r, eps), eps)) + r - 1.0)


class TweedieMetric(_Pointwise):
    name = "tweedie"

    def point(self, p, y):
        rho = self.cfg.tweedie_variance_power
        x = np.maximum(p, 1e-10)
        return -y * np.power(x, 1 - rho) / (1 - rho) + np.power(x, 2 - rho) / (2 - rho)


class MAPEMetric(_Pointwise):
    name = "mape"

    def point(self, p, y):
        return np.abs(p - y) / np.maximum(1.0, np.abs(y))


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

    def eval(self, pred, label, weight, query_boundaries=None):
        return [(self.name, _auc(np.asarray(pred), np.asarray(label), weight), True)]


class CrossEntropyMetric(_Pointwise):
    name = "cross_entropy"

    def point(self, p, y):
        p = np.clip(p, EPS, 1 - EPS)
        return -(y * np.log(p) + (1 - y) * np.log(1 - p))


class XentLambdaMetric(Metric):
    """reference: CrossEntropyLambdaMetric in xentropy_metric.hpp: the
    lambda-parameterized cross entropy, where a weight scales the intensity
    lambda = w * log1p(e^f) rather than the loss."""

    name = "xentropy_lambda"

    def eval(self, pred, label, weight, query_boundaries=None):
        p = np.clip(np.asarray(pred, np.float64), EPS, 1 - EPS)
        t = np.asarray(label, np.float64)
        f = np.log(p / (1 - p))
        w = np.ones_like(p) if weight is None else np.asarray(weight, np.float64)
        lam = w * np.log1p(np.exp(f))
        loss = (1 - t) * lam - t * np.log(-np.expm1(-np.maximum(lam, 1e-300)))
        return [(self.name, float(np.mean(loss)), False)]


class AucMuMetric(Metric):
    """Multiclass AUC-mu (reference: auc_mu in multiclass_metric.hpp,
    Kleiman & Page 2019): the mean over class pairs (i, j) of the AUC that
    separates class i from class j by the margin pred[:, i] - pred[:, j],
    optionally weighted by the auc_mu_weights cost matrix."""

    name = "auc_mu"
    is_higher_better = True

    def __init__(self, cfg=None):
        self.cfg = cfg
        self.weights = None
        w = list(getattr(cfg, "auc_mu_weights", []) or []) if cfg is not None else []
        if w:
            k = int(round(len(w) ** 0.5))
            if k * k == len(w):
                self.weights = np.asarray(w, np.float64).reshape(k, k)

    def eval(self, pred, label, weight, query_boundaries=None):
        p = np.asarray(pred)
        y = np.asarray(label).astype(np.int64)
        k = p.shape[1]
        total, wsum = 0.0, 0.0
        for i in range(k):
            for j in range(i + 1, k):
                rows = (y == i) | (y == j)
                if not rows.any() or (y[rows] == i).all() or (y[rows] == j).all():
                    continue
                margin = p[rows, i] - p[rows, j]
                lab = (y[rows] == i).astype(np.float64)
                wrow = None if weight is None else np.asarray(weight)[rows]
                a = _auc(margin, lab, wrow)
                pw = (2.0 if self.weights is None
                      else float(self.weights[i, j] + self.weights[j, i]))
                total += pw * a
                wsum += pw
        return [(self.name, total / max(wsum, 1e-30), True)]


class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, pred, label, weight, query_boundaries=None):
        p = np.asarray(pred)  # (N, K)
        y = np.asarray(label).astype(np.int64)
        probs = np.clip(p[np.arange(len(y)), y], EPS, None)
        return [(self.name, _wmean(-np.log(probs), weight), False)]


class MultiErrorMetric(Metric):
    name = "multi_error"

    def eval(self, pred, label, weight, query_boundaries=None):
        p = np.asarray(pred)
        y = np.asarray(label).astype(np.int64)
        k = self.cfg.multi_error_top_k
        if k <= 1:
            err = (np.argmax(p, axis=1) != y).astype(np.float64)
        else:
            topk = np.argsort(-p, axis=1)[:, :k]
            err = 1.0 - (topk == y[:, None]).any(axis=1).astype(np.float64)
        return [(self.name, _wmean(err, weight), False)]


def pad_queries(query_boundaries: np.ndarray, width: int = 0):
    """Queries as a dense (Q, S) padded block, S the longest query (or
    ``width`` if larger): the layout the ranking objectives use.  Returns
    (pad_idx, pad_mask); padded lanes point at row 0 with the mask off."""
    qb = np.asarray(query_boundaries)
    nq = len(qb) - 1
    lens = np.diff(qb)
    smax = max(int(lens.max()) if nq else 0, int(width))
    pos = np.arange(smax)[None, :]
    pad_mask = pos < lens[:, None]
    pad_idx = np.where(pad_mask, qb[:-1, None] + pos, 0).astype(np.int64)
    return pad_idx, pad_mask


class NDCGMetric(Metric):
    name = "ndcg"
    is_higher_better = True

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        gains = cfg.label_gain or [float(2**i - 1) for i in range(31)]
        self.label_gain = np.asarray(gains, dtype=np.float64)

    def eval(self, pred, label, weight, query_boundaries=None):
        if query_boundaries is None:
            raise ValueError("ndcg needs query information (Dataset group=)")
        return [(f"ndcg@{k}", ndcg_at_k(np.asarray(pred), np.asarray(label),
                                        query_boundaries, k, self.label_gain), True)
                for k in self.cfg.eval_at]


class MAPMetric(Metric):
    name = "map"
    is_higher_better = True

    def eval(self, pred, label, weight, query_boundaries=None):
        if query_boundaries is None:
            raise ValueError("map needs query information (Dataset group=)")
        scores, labels = np.asarray(pred), np.asarray(label)
        nq = len(query_boundaries) - 1
        out = []
        for k in self.cfg.eval_at:
            total = 0.0
            for q in range(nq):
                lo, hi = query_boundaries[q], query_boundaries[q + 1]
                order = np.argsort(-scores[lo:hi], kind="stable")
                rel = (labels[lo:hi][order] > 0).astype(np.float64)
                kk = min(k, hi - lo)
                hits = np.cumsum(rel[:kk])
                prec = hits / np.arange(1, kk + 1)
                denom = max(min(int(rel.sum()), kk), 1)
                total += float(np.sum(prec * rel[:kk]) / denom)
            out.append((f"map@{k}", total / max(nq, 1), True))
        return out


_METRICS: Dict[str, Callable[[Config], Metric]] = {
    "l2": L2Metric, "mse": L2Metric, "mean_squared_error": L2Metric,
    "regression": L2Metric, "regression_l2": L2Metric,
    "rmse": RMSEMetric, "l2_root": RMSEMetric, "root_mean_squared_error": RMSEMetric,
    "l1": L1Metric, "mae": L1Metric, "mean_absolute_error": L1Metric,
    "regression_l1": L1Metric,
    "quantile": QuantileMetric,
    "huber": HuberMetric,
    "fair": FairMetric,
    "poisson": PoissonMetric,
    "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "mape": MAPEMetric, "mean_absolute_percentage_error": MAPEMetric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "cross_entropy": CrossEntropyMetric, "xentropy": CrossEntropyMetric,
    "auc_mu": AucMuMetric,
    "xentropy_lambda": XentLambdaMetric,
    "multi_logloss": MultiLoglossMetric, "multiclass": MultiLoglossMetric,
    "softmax": MultiLoglossMetric, "multiclassova": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "ndcg": NDCGMetric, "lambdarank": NDCGMetric, "rank_xendcg": NDCGMetric,
    "map": MAPMetric, "mean_average_precision": MAPMetric,
}

_DEFAULT_METRIC_FOR_OBJECTIVE: Dict[str, str] = {
    "regression": "l2",
    "regression_l1": "l1",
    "huber": "huber",
    "fair": "fair",
    "poisson": "poisson",
    "gamma": "gamma",
    "tweedie": "tweedie",
    "quantile": "quantile",
    "mape": "mape",
    "binary": "binary_logloss",
    "multiclass": "multi_logloss",
    "multiclassova": "multi_logloss",
    "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "xentropy_lambda",
    "xentlambda": "xentropy_lambda",
    "lambdarank": "ndcg",
    "rank_xendcg": "ndcg",
}


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
            raise ValueError(f"Unknown metric: {name}")
        out.append(_METRICS[name](cfg))
    return out
