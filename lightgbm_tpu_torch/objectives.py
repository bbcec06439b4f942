"""Objective functions: gradients and hessians as tensor functions.

Counterpart of lightgbm_tpu/objectives.py.  This slice ports the L2
regression and binary log-loss objectives; the other twelve raise
NotImplementedError (ROADMAP queue A4).

Each objective exposes:
  * get_gradients(score, label, weight) -> (grad, hess), (N,) f32
  * boost_from_score(label, weight) -> float init score (reference:
    ObjectiveFunction::BoostFromScore, used when boost_from_average=true)
  * convert_output(score) -> prediction-space outputs
  * need_renew and is_fusable(), which models/gbdt.py::_fused_eligible
    reads as the JAX package does: an objective that renews leaf outputs
    after growth, or keeps per-iteration host state, cannot take the fused
    path
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config

Tensor = torch.Tensor


class Objective:
    name = "custom"
    need_renew = False
    # get_gradients is a pure tensor function of (score, label, weight), with
    # no per-iteration host state
    fusable = True

    def __init__(self, cfg: Config):
        self.cfg = cfg

    def is_fusable(self) -> bool:
        return self.fusable

    def prepare(self, label: np.ndarray, weight) -> None:
        """Label-dependent state, set once per training set."""

    def get_gradients(self, score: Tensor, label: Tensor,
                      weight: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
        raise NotImplementedError

    def boost_from_score(self, label: Tensor, weight: Optional[Tensor]) -> float:
        return 0.0

    def convert_output(self, score: Tensor) -> Tensor:
        return score

    def _w(self, weight, label):
        return torch.ones_like(label) if weight is None else weight


class RegressionL2(Objective):
    """reference: RegressionL2loss (reg_sqrt fits sign(y)*sqrt(|y|) and
    squares predictions back)."""

    name = "regression"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.sqrt = bool(cfg.reg_sqrt)

    def _t(self, label):
        if self.sqrt:
            return torch.sign(label) * torch.sqrt(torch.abs(label))
        return label

    def get_gradients(self, score, label, weight):
        w = self._w(weight, label)
        return (score - self._t(label)) * w, w

    def boost_from_score(self, label, weight):
        label = self._t(label)
        if weight is None:
            return float(torch.mean(label))
        return float(torch.sum(label * weight) / torch.sum(weight))

    def convert_output(self, score):
        if self.sqrt:
            return torch.sign(score) * score * score
        return score


class BinaryLogloss(Objective):
    """reference: BinaryLogloss in binary_objective.hpp.

    grad = sigmoid_scale * (p - y) * label_weight; hess = scale^2 p (1-p) w.
    is_unbalance / scale_pos_weight set the positive-label weight."""

    name = "binary"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.pos_weight = cfg.scale_pos_weight

    def prepare(self, label: np.ndarray, weight) -> None:
        if self.cfg.is_unbalance:
            pos = float(np.sum(label > 0))
            neg = float(len(label) - pos)
            if pos > 0 and neg > 0:
                self.pos_weight = neg / pos

    def get_gradients(self, score, label, weight):
        sig = self.cfg.sigmoid
        w = self._w(weight, label)
        y = torch.where(label > 0, 1.0, -1.0)
        lw = torch.where(label > 0, self.pos_weight, 1.0) * w
        response = -y * sig / (1.0 + torch.exp(y * sig * score))
        grad = response * lw
        hess = torch.abs(response) * (sig - torch.abs(response)) * lw
        return grad, hess

    def boost_from_score(self, label, weight):
        pos = torch.where(label > 0, 1.0, 0.0)
        if weight is None:
            p = float(torch.mean(pos))
        else:
            p = float(torch.sum(pos * weight) / torch.sum(weight))
        p = min(max(p, 1e-15), 1.0 - 1e-15)
        return float(np.log(p / (1.0 - p)) / self.cfg.sigmoid)

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-self.cfg.sigmoid * score))


_REGISTRY = {"regression": RegressionL2, "binary": BinaryLogloss}
_NOT_PORTED = ("regression_l1", "huber", "fair", "poisson", "gamma", "tweedie",
               "quantile", "mape", "multiclass", "multiclassova",
               "cross_entropy", "cross_entropy_lambda", "lambdarank",
               "rank_xendcg")


def create_objective(cfg: Config) -> Optional[Objective]:
    """reference: ObjectiveFunction::CreateObjectiveFunction."""
    name = cfg.objective
    if name in ("none", "null", "custom", "na", ""):
        return None
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"objective={name} is not ported to lightgbm_tpu_torch yet "
            "(ROADMAP queue A4)")
    if name not in _REGISTRY:
        raise ValueError(f"Unknown objective: {name}")
    return _REGISTRY[name](cfg)
