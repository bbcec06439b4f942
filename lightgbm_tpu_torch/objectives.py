"""Objective functions: gradients and hessians as tensor functions.

Counterpart of lightgbm_tpu/objectives.py: the same sixteen objectives
under the same registry names.  Every gradient is a torch function of
device tensors; the ranking objectives lay their queries out as a padded
(Q, S) block (metrics.pad_queries) and compute each query's lambdas with no
Python loop over queries.

Each objective exposes:
  * get_gradients(score, label, weight) -> (grad, hess), (N,) or (N, K) f32
  * boost_from_score(label, weight) -> float init score (reference:
    ObjectiveFunction::BoostFromScore, used when boost_from_average=true)
  * convert_output(score) -> prediction-space outputs
  * renew_tree_output(...) -> per-leaf refit (L1, quantile, MAPE; reference:
    RenewTreeOutput), a weighted quantile per leaf on the device
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


def _host_exact(torch_fn, numpy_fn):
    """``torch_fn``, except on a CPU tensor, where numpy's ``numpy_fn`` runs
    in float64 and the result is rounded to the tensor's dtype.  torch's
    CPU kernels for exp and log2 call MKL's vector math, which picks its
    code path per process at run time: under host load one process took
    another path than its neighbour, and the last bits of the gradients,
    and so the trees, parted (ROADMAP C21).  numpy's loops pick theirs from
    the CPU's features alone, and its float64 result rounded to float32 is
    the correctly rounded value but for ties (as near the JAX package's
    float32 exp as MKL's is: 18,789 against 19,005 of 200,000 draws part
    from it).  On the card torch's kernels stay.  cross_entropy_lambda's
    gradients on the CPU are closed forms over the float64 values of the
    same functions (CrossEntropyLambda._host_gradients, ROADMAP C25)."""
    def fn(x: Tensor) -> Tensor:
        if x.device.type != "cpu":
            return torch_fn(x)
        a = x.detach().numpy()
        return torch.from_numpy(np.asarray(numpy_fn(a.astype(np.float64)), a.dtype))
    return fn


_exp = _host_exact(torch.exp, np.exp)
_log2 = _host_exact(torch.log2, np.log2)


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

    def renew_tree_output(self, label, weight, score, leaf_id,
                          num_leaves: int) -> Optional[Tensor]:
        return None

    def _w(self, weight, label):
        return torch.ones_like(label) if weight is None else weight


def _mean(label: Tensor, weight: Optional[Tensor]) -> float:
    if weight is None:
        return float(torch.mean(label))
    return float(torch.sum(label * weight) / torch.sum(weight))


class RegressionL2(Objective):
    """reference: RegressionL2loss (reg_sqrt fits sign(y)*sqrt(|y|) and
    squares predictions back; plain L2 only, as in the reference)."""

    name = "regression"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.sqrt = bool(cfg.reg_sqrt) and type(self) is RegressionL2

    def _t(self, label):
        if self.sqrt:
            return torch.sign(label) * torch.sqrt(torch.abs(label))
        return label

    def get_gradients(self, score, label, weight):
        w = self._w(weight, label)
        return (score - self._t(label)) * w, w

    def boost_from_score(self, label, weight):
        return _mean(self._t(label), weight)

    def convert_output(self, score):
        if self.sqrt:
            return torch.sign(score) * score * score
        return score


class RegressionL1(Objective):
    """reference: RegressionL1loss -- the gradient is a sign, each leaf is
    renewed to the weighted median of its residuals."""

    name = "regression_l1"
    need_renew = True

    def get_gradients(self, score, label, weight):
        w = self._w(weight, label)
        return torch.sign(score - label) * w, w

    def boost_from_score(self, label, weight):
        return _weighted_quantile_np(_np(label), _np(weight), 0.5)

    def renew_tree_output(self, label, weight, score, leaf_id, num_leaves):
        return per_leaf_weighted_quantile(label - score, self._w(weight, label),
                                          leaf_id, num_leaves, 0.5)


class RegressionHuber(RegressionL2):
    """reference: RegressionHuberLoss (alpha)."""

    name = "huber"

    def get_gradients(self, score, label, weight):
        a = self.cfg.alpha
        w = self._w(weight, label)
        diff = score - label
        g = torch.where(torch.abs(diff) <= a, diff, torch.sign(diff) * a)
        return g * w, w


class RegressionFair(Objective):
    """reference: RegressionFairLoss (fair_c)."""

    name = "fair"

    def get_gradients(self, score, label, weight):
        c = self.cfg.fair_c
        w = self._w(weight, label)
        x = score - label
        g = c * x / (torch.abs(x) + c)
        h = c * c / ((torch.abs(x) + c) ** 2)
        return g * w, h * w


class RegressionPoisson(Objective):
    """reference: RegressionPoissonLoss -- scores in log space, the hessian
    carries the poisson_max_delta_step safeguard."""

    name = "poisson"

    def get_gradients(self, score, label, weight):
        w = self._w(weight, label)
        g = (_exp(score) - label) * w
        h = _exp(score + self.cfg.poisson_max_delta_step) * w
        return g, h

    def boost_from_score(self, label, weight):
        w = torch.ones_like(label) if weight is None else weight
        mean = float(torch.sum(label * w) / torch.sum(w))
        return float(np.log(max(mean, 1e-9)))

    def convert_output(self, score):
        return _exp(score)


class RegressionGamma(RegressionPoisson):
    """reference: RegressionGammaLoss."""

    name = "gamma"

    def get_gradients(self, score, label, weight):
        w = self._w(weight, label)
        g = (1.0 - label * _exp(-score)) * w
        h = label * _exp(-score) * w
        return g, h


class RegressionTweedie(RegressionPoisson):
    """reference: RegressionTweedieLoss (tweedie_variance_power rho)."""

    name = "tweedie"

    def get_gradients(self, score, label, weight):
        rho = self.cfg.tweedie_variance_power
        w = self._w(weight, label)
        exp1 = _exp((1.0 - rho) * score)
        exp2 = _exp((2.0 - rho) * score)
        g = (-label * exp1 + exp2) * w
        h = (-label * (1.0 - rho) * exp1 + (2.0 - rho) * exp2) * w
        return g, h


class RegressionQuantile(Objective):
    """reference: RegressionQuantileloss (alpha); each leaf is renewed to
    the alpha quantile of its residuals."""

    name = "quantile"
    need_renew = True

    def get_gradients(self, score, label, weight):
        a = self.cfg.alpha
        w = self._w(weight, label)
        g = torch.where(score >= label, 1.0 - a, -a)
        return g * w, w

    def boost_from_score(self, label, weight):
        return _weighted_quantile_np(_np(label), _np(weight), self.cfg.alpha)

    def renew_tree_output(self, label, weight, score, leaf_id, num_leaves):
        return per_leaf_weighted_quantile(label - score, self._w(weight, label),
                                          leaf_id, num_leaves, self.cfg.alpha)


class RegressionMAPE(Objective):
    """reference: RegressionMAPELOSS -- label-scaled weights, median
    renewal."""

    name = "mape"
    need_renew = True

    def get_gradients(self, score, label, weight):
        w = self._w(weight, label)
        scale = w / torch.clamp_min(torch.abs(label), 1.0)
        scale = scale / torch.mean(scale)
        return torch.sign(score - label) * scale, scale

    def boost_from_score(self, label, weight):
        # the same 1/max(1,|label|)-scaled weights as the boosting rounds
        lab = _np(label).astype(np.float64)
        w = np.ones_like(lab) if weight is None else _np(weight).astype(np.float64)
        w = w / np.maximum(1.0, np.abs(lab))
        return _weighted_quantile_np(lab, w, 0.5)

    def renew_tree_output(self, label, weight, score, leaf_id, num_leaves):
        w = self._w(weight, label) / torch.clamp_min(torch.abs(label), 1.0)
        return per_leaf_weighted_quantile(label - score, w, leaf_id, num_leaves, 0.5)


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
        response = -y * sig / (1.0 + _exp(y * sig * score))
        grad = response * lw
        hess = torch.abs(response) * (sig - torch.abs(response)) * lw
        return grad, hess

    def boost_from_score(self, label, weight):
        pos = torch.where(label > 0, 1.0, 0.0)
        p = min(max(_mean(pos, weight), 1e-15), 1.0 - 1e-15)
        return float(np.log(p / (1.0 - p)) / self.cfg.sigmoid)

    def convert_output(self, score):
        return 1.0 / (1.0 + _exp(-self.cfg.sigmoid * score))


def _one_hot(label: Tensor, k: int, dtype) -> Tensor:
    return torch.nn.functional.one_hot(label.long(), k).to(dtype)


class MulticlassSoftmax(Objective):
    """reference: MulticlassSoftmax -- K trees an iteration; the hessian
    carries the factor-2 convention."""

    name = "multiclass"

    def get_gradients(self, score, label, weight):
        # score (N, K); label (N,) class ids
        w = self._w(weight, label)[:, None]
        p = torch.softmax(score, dim=-1)
        y = _one_hot(label, self.cfg.num_class, score.dtype)
        return (p - y) * w, 2.0 * p * (1.0 - p) * w

    def convert_output(self, score):
        return torch.softmax(score, dim=-1)


class MulticlassOVA(Objective):
    """reference: MulticlassOVA -- K independent binary problems."""

    name = "multiclassova"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.binary = BinaryLogloss(cfg)

    def get_gradients(self, score, label, weight):
        y = _one_hot(label, self.cfg.num_class, score.dtype)
        return self.binary.get_gradients(
            score, y, None if weight is None else weight[:, None])

    def convert_output(self, score):
        return 1.0 / (1.0 + _exp(-self.cfg.sigmoid * score))


class CrossEntropy(Objective):
    """reference: CrossEntropy in xentropy_objective.hpp (labels in [0,1])."""

    name = "cross_entropy"

    def get_gradients(self, score, label, weight):
        w = self._w(weight, label)
        p = 1.0 / (1.0 + _exp(-score))
        return (p - label) * w, p * (1.0 - p) * w

    def boost_from_score(self, label, weight):
        p = min(max(_mean(label, weight), 1e-15), 1 - 1e-15)
        return float(np.log(p / (1 - p)))

    def convert_output(self, score):
        return 1.0 / (1.0 + _exp(-score))


class CrossEntropyLambda(Objective):
    """reference: CrossEntropyLambda in xentropy_objective.hpp ("xentlambda"):
    the weight scales the intensity lambda = w * log1p(e^f); the label is a
    probability in [0, 1].  Gradients and hessians are the elementwise
    derivatives of the stable loss expression, taken with torch.func as the
    JAX package takes them with jax.grad; on a CPU tensor they are the same
    derivatives in closed form, computed in float64 numpy and rounded once
    (``_host_gradients``), since torch's CPU exp, log1p, log and expm1 go
    through MKL's per-process code path (ROADMAP C25, as C21)."""

    name = "cross_entropy_lambda"

    @staticmethod
    def _loss(f, t, w):
        lam = w * torch.log1p(torch.exp(f))
        # -log(1 - e^-lam), stably
        log1m = torch.log(-torch.expm1(-torch.clamp_min(lam, 1e-30)))
        return (1.0 - t) * lam - t * log1m

    @staticmethod
    def _host_gradients(score, label, weight):
        """(g, h) of ``_loss`` on CPU tensors: with lam = w * softplus(f),
        dL/dlam = (1 - t) - t / expm1(lam) and d2L/dlam2 = t * e^lam /
        expm1(lam)^2 (the t terms dropped where lam < 1e-30, as the clamp's
        derivative drops them); g = dL/dlam * w * s, h = d2L/dlam2 * (w *
        s)^2 + dL/dlam * w * s * (1 - s), s = sigmoid(f).  float64, rounded
        once to the score's dtype; h >= 1e-8."""
        a = score.detach().numpy()
        f = a.astype(np.float64)
        t = label.detach().numpy().astype(np.float64)
        w = (np.ones_like(f) if weight is None
             else weight.detach().numpy().astype(np.float64))
        with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
            sp = np.log1p(np.exp(f))
            sp = np.where(np.isinf(sp), f, sp)  # softplus(f) = f past exp's range
            s = 0.5 * (1.0 + np.tanh(0.5 * f))  # sigmoid, stable both ways
            lam = w * sp
            live = lam >= 1e-30
            lam_c = np.maximum(lam, 1e-30)
            em1 = np.expm1(lam_c)
            d1 = (1.0 - t) - np.where(live, t / em1, 0.0)
            d2 = np.where(live, t * np.exp(lam_c) / (em1 * em1), 0.0)
            dl = w * s
            g = d1 * dl
            h = d2 * dl * dl + d1 * dl * (1.0 - s)
        return (torch.from_numpy(g.astype(a.dtype)),
                torch.from_numpy(np.maximum(h, 1e-8).astype(a.dtype)))

    def get_gradients(self, score, label, weight):
        from torch.func import grad, vmap

        if score.device.type == "cpu":
            return self._host_gradients(score, label, weight)
        w = torch.ones_like(score) if weight is None else weight
        g = vmap(grad(self._loss))(score, label, w)
        h = vmap(grad(grad(self._loss)))(score, label, w)
        return g, torch.clamp_min(h, 1e-8)

    def convert_output(self, score):
        return torch.sigmoid(score)

    def boost_from_score(self, label, weight):
        p = float(torch.clamp(torch.mean(label), 1e-6, 1 - 1e-6))
        return float(np.log(p / (1 - p)))


class _RankingObjective(Objective):
    """Queries as a dense (Q, S) block padded to the longest query
    (reference: RankingObjective in rank_objective.hpp, a per-query
    parallel loop); padded lanes carry zeros."""

    # per-iteration host state (XE-NDCG's draw counter); LambdaRank keeps
    # none unless it learns position biases
    fusable = False

    def set_query(self, query_boundaries: np.ndarray, labels: np.ndarray,
                  device, width: int = 0) -> None:
        """``width``: pad to at least this many lanes (a distributed
        training pads every rank's queries to the longest query of all, so
        each query's sums over its lanes have the serial run's shape and
        order)."""
        from .metrics import pad_queries

        self.query_boundaries = np.asarray(query_boundaries)
        pad_idx, pad_mask = pad_queries(self.query_boundaries, width)
        self._pad_idx = torch.as_tensor(pad_idx, device=device)
        self._pad_mask = torch.as_tensor(pad_mask, device=device)
        # the real lanes (flat) and their rows: a scatter back with no mask
        # to count on the device
        lanes = np.flatnonzero(pad_mask.reshape(-1))
        self._lanes = torch.as_tensor(lanes, device=device)
        self._lane_rows = torch.as_tensor(pad_idx.reshape(-1)[lanes], device=device)

    def _padded(self, v: Tensor) -> Tensor:
        idx = self._pad_idx
        return v[idx.reshape(-1)].reshape(idx.shape)

    def _scatter(self, like: Tensor, g: Tensor) -> Tensor:
        """(Q, S) per-lane values back to (N,) rows; padded lanes dropped."""
        out = torch.zeros_like(like)
        out[self._lane_rows] = g.reshape(-1)[self._lanes]
        return out


class RankXENDCG(_RankingObjective):
    """reference: RankXENDCGObjective in rank_xendcg_objective.hpp -- the
    listwise cross-entropy NDCG surrogate (Bruch 2020).  Per query: rho =
    softmax(scores), phi_i = 2^label_i - u_i with u_i ~ U(0, 1) drawn anew
    each iteration, then the three-term gradient of xendcg_query.  The draws
    come from this objective's torch.Generator, seeded from objective_seed
    and the iteration (the JAX package draws from jax.random, another
    stream: parity holds with the draws given, ``draws``)."""

    name = "rank_xendcg"

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self._iter = 0
        self._seed = int(cfg.objective_seed)

    def draws(self, shape, device) -> Tensor:
        """This iteration's uniforms, (Q, S) f32."""
        gen = torch.Generator(device=device)
        gen.manual_seed(self._seed + self._iter)
        return torch.rand(shape, generator=gen, device=device)

    def get_gradients(self, score, label, weight):
        u = self.draws(tuple(self._pad_idx.shape), score.device)
        self._iter += 1
        g, h = xendcg_query(self._padded(score), self._padded(label),
                            self._pad_mask, u)
        return self._scatter(score, g), self._scatter(score, h)


def xendcg_query(scores, labels, mask, u):
    """XE-NDCG gradients over padded queries: (Q, S) in and out."""
    masked = torch.where(mask, scores, -1e30)
    rho = torch.where(mask, torch.softmax(masked, dim=1), 0.0)
    phi = torch.where(mask, torch.exp2(labels.float()) - u, 0.0)
    denom = torch.clamp_min(phi.sum(dim=1, keepdim=True), 1e-20)
    l1 = rho - phi / denom
    l2 = l1 - rho * l1.sum(dim=1, keepdim=True)
    lam = l2 - rho * l2.sum(dim=1, keepdim=True)
    hess = rho * (1.0 - rho)
    return torch.where(mask, lam, 0.0), torch.where(mask, hess, 0.0)


class LambdarankNDCG(_RankingObjective):
    """reference: LambdarankNDCG in rank_objective.hpp: pairwise
    NDCG-weighted lambdas inside each query, truncated to
    lambdarank_truncation_level, computed as dense (Q, S, S) blocks of
    queries (``lambdarank_pairwise``).  With positions (Dataset(position=)),
    a learned additive bias per position enters the lambdas and is refit by
    a Newton step each iteration (reference: UpdatePositionBiasFactors)."""

    name = "lambdarank"
    fusable = True

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.truncation = cfg.lambdarank_truncation_level
        self.norm = cfg.lambdarank_norm
        self.sigmoid = cfg.sigmoid if cfg.sigmoid > 0 else 1.0
        gains = cfg.label_gain or [float(2**i - 1) for i in range(31)]
        self.label_gain = np.asarray(gains, dtype=np.float64)
        self._pos_pad = None
        self.pos_bias = None

    def is_fusable(self) -> bool:
        return self._pos_pad is None

    def set_query(self, query_boundaries, labels, device, width: int = 0) -> None:
        """Also the inverse max DCG of each query (reference:
        inverse_max_dcgs_ in LambdarankNDCG::Init)."""
        from .metrics import dcg_at_k

        super().set_query(query_boundaries, labels, device, width)
        qb = self.query_boundaries
        inv = np.zeros(len(qb) - 1, dtype=np.float64)
        for q in range(len(qb) - 1):
            ql = labels[qb[q]:qb[q + 1]]
            m = dcg_at_k(np.sort(ql)[::-1], min(len(ql), self.truncation),
                         self.label_gain)
            inv[q] = 1.0 / m if m > 0 else 0.0
        self._gains = torch.as_tensor(self.label_gain, dtype=torch.float32,
                                      device=device)
        self._inv_mdcg = torch.as_tensor(inv, dtype=torch.float32, device=device)

    def set_positions(self, positions: np.ndarray) -> None:
        positions = np.asarray(positions, np.int64).ravel()
        idx = self._pad_idx.cpu().numpy()
        dev = self._pad_idx.device
        self._pos_pad = torch.as_tensor(positions[idx], device=dev)
        self.num_positions = int(positions.max()) + 1
        self.pos_bias = torch.zeros(self.num_positions, dtype=torch.float32,
                                    device=dev)
        self.pos_reg = float(self.cfg.lambdarank_position_bias_regularization)

    def get_gradients(self, score, label, weight):
        msk = self._pad_mask
        s = self._padded(score)
        if self._pos_pad is not None:
            s = s + torch.where(msk, self.pos_bias[self._pos_pad], 0.0)
        g, h = lambdarank_pairwise(s, self._padded(label), msk, self._gains,
                                   self._inv_mdcg, self.sigmoid,
                                   self.truncation, self.norm)
        if self._pos_pad is not None:
            P = self.num_positions
            pp = self._pos_pad.reshape(-1)
            Gp = torch.zeros(P, device=score.device).index_add_(
                0, pp, torch.where(msk, g, 0.0).reshape(-1))
            Hp = torch.zeros(P, device=score.device).index_add_(
                0, pp, torch.where(msk, h, 0.0).reshape(-1))
            reg = self.pos_reg
            self.pos_bias = self.pos_bias - (Gp + reg * self.pos_bias) / (Hp + reg + 1e-9)
        return self._scatter(score, g), self._scatter(score, h)


# queries per block of the pairwise planes: (block, S, S) f32 planes stay
# near 2^26 elements (256 MiB) each
_PAIR_BLOCK_ELEMS = 2 ** 26


def lambdarank_pairwise(scores, labels, mask, label_gain, inv_mdcg,
                        sigmoid: float, truncation: int, norm: bool):
    """Pairwise lambdas over padded queries, (Q, S) in and out, one block of
    queries at a time (every block's result is that of the whole)."""
    q, s_len = scores.shape
    step = max(1, _PAIR_BLOCK_ELEMS // max(s_len * s_len, 1))
    if q <= step:
        return _lambdarank_block(scores, labels, mask, label_gain, inv_mdcg,
                                 sigmoid, truncation, norm)
    parts = [_lambdarank_block(scores[i:i + step], labels[i:i + step],
                               mask[i:i + step], label_gain, inv_mdcg[i:i + step],
                               sigmoid, truncation, norm)
             for i in range(0, q, step)]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


def _lambdarank_block(scores, labels, mask, label_gain, inv_mdcg, sigmoid,
                      truncation, norm):
    masked = torch.where(mask, scores, -1e30)
    # rank of each item within its query by current score (descending)
    order = torch.argsort(-masked, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1)
    lg = label_gain[labels.long().clamp(0, label_gain.shape[0] - 1)]
    lg = torch.where(mask, lg, 0.0)
    in_window = ranks < truncation
    disc = torch.where(in_window, 1.0 / _log2(ranks.float() + 2.0), 0.0)

    d_s = scores[:, :, None] - scores[:, None, :]
    d_gain = lg[:, :, None] - lg[:, None, :]
    d_disc = disc[:, :, None] - disc[:, None, :]
    delta_ndcg = torch.abs(d_gain) * torch.abs(d_disc) * inv_mdcg[:, None, None]
    better = ((labels[:, :, None] > labels[:, None, :]) & mask[:, :, None]
              & mask[:, None, :])
    better = better & (in_window[:, :, None] | in_window[:, None, :])

    rho = 1.0 / (1.0 + _exp(sigmoid * d_s))
    lam = torch.where(better, sigmoid * rho * delta_ndcg, 0.0)
    hes = torch.where(better, sigmoid * sigmoid * rho * (1.0 - rho) * delta_ndcg,
                      0.0)
    grad = -lam.sum(dim=2) + lam.transpose(1, 2).sum(dim=2)
    hess = hes.sum(dim=2) + hes.transpose(1, 2).sum(dim=2)
    if norm:
        total = torch.abs(lam).sum(dim=(1, 2))[:, None]
        scale = torch.where(total > 0,
                            _log2(1.0 + total) / torch.clamp_min(total, 1e-20),
                            1.0)
        grad = grad * scale
        hess = hess * scale
    return torch.where(mask, grad, 0.0), torch.where(mask, hess, 0.0)


# ---------------------------------------------------------------------------
# per-leaf weighted quantile (the renewal of L1, quantile and MAPE)
# ---------------------------------------------------------------------------
def per_leaf_weighted_quantile(values: Tensor, weights: Tensor,
                               leaf_id: Tensor, num_leaves: int,
                               q: float) -> Tensor:
    """Weighted q-quantile of ``values`` within each leaf, (L,) f32: in
    each leaf, the smallest value whose cumulative weight (values in
    ascending order, ties in row order) reaches q x the leaf's total
    (reference: WeightedPercentileFun in regression_objective.hpp; the JAX
    package's masked per-leaf search over one shared sort).  One sort by
    value, one stable sort by leaf, and a segmented float64 prefix sum: no
    host read, and O(N) memory whatever the number of leaves.  A leaf with
    no rows gets the smallest value (the JAX package's index 0)."""
    n = values.shape[0]
    L = num_leaves
    dev = values.device
    by_value = torch.argsort(values, stable=True)
    lid = leaf_id.long()[by_value]
    by_leaf = torch.argsort(lid, stable=True)
    order = by_value[by_leaf]  # rows by (leaf, value)
    lid = lid[by_leaf]
    v = values[order]
    w = weights[order].double()
    counts = torch.zeros(L, dtype=torch.int64, device=dev).index_add_(
        0, lid, torch.ones_like(lid))
    start = torch.cumsum(counts, 0) - counts  # first position of each leaf
    cum = torch.cumsum(w, 0)
    before = torch.where(start > 0, cum[(start - 1).clamp_min(0)], 0.0)
    seg_cum = cum - before[lid]  # cumulative weight inside the leaf
    total = torch.zeros(L, dtype=torch.float64, device=dev).index_add_(0, lid, w)
    target = (q * total.float()).double()
    # first position in the leaf whose cumulative weight reaches the target
    below = torch.zeros(L, dtype=torch.int64, device=dev).index_add_(
        0, lid, (seg_cum < target[lid]).long())
    pos = (start + torch.minimum(below, (counts - 1).clamp_min(0))).clamp(0, n - 1)
    return torch.where(counts > 0, v[pos], values.min())


def _np(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _weighted_quantile_np(values, weights, q) -> float:
    """Host weighted quantile for BoostFromScore (a copy of the JAX
    package's: the midpoint convention for unweighted even counts)."""
    order = np.argsort(values)
    v = values[order]
    if weights is None:
        n = len(v)
        if n == 0:
            return 0.0
        pos = q * (n - 1)
        lo, hi = int(np.floor(pos)), int(np.ceil(pos))
        return float(0.5 * (v[lo] + v[hi])) if hi != lo else float(v[lo])
    w = np.asarray(weights)[order]
    cum = np.cumsum(w)
    idx = int(np.searchsorted(cum, q * cum[-1], side="left"))
    return float(v[min(idx, len(v) - 1)])


# ---------------------------------------------------------------------------
_REGISTRY = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": RegressionHuber,
    "fair": RegressionFair,
    "poisson": RegressionPoisson,
    "gamma": RegressionGamma,
    "tweedie": RegressionTweedie,
    "quantile": RegressionQuantile,
    "mape": RegressionMAPE,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
    "rank_xendcg": RankXENDCG,
}


def create_objective(cfg: Config) -> Optional[Objective]:
    """reference: ObjectiveFunction::CreateObjectiveFunction."""
    name = cfg.objective
    if name in ("none", "null", "custom", "na", ""):
        return None
    if name not in _REGISTRY:
        raise ValueError(f"Unknown objective: {name}")
    return _REGISTRY[name](cfg)
