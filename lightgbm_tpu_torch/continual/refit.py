"""The continual leaf refit on the device (README "Continuous training").

Counterpart of lightgbm_tpu/continual/refit.py, in torch.  ``Booster.refit``
(reference: GBDT::RefitTree) keeps every tree's structure and renews its
leaf values on fresh data as ``new = decay * old + (1 - decay) *
(-G_leaf / (H_leaf + lambda_l2))``, with each tree's gradients taken at the
score of the already renewed trees before it.  Here the whole refit runs
on the model's device: one traversal of the stacked ensemble gives every
row's leaf in every tree, then a pass a tree takes the gradients at the
running score, sums them per leaf and renews the leaves, and adds the
renewed tree to the score; the host reads the renewed tables once.

The per-leaf sums are B1's (hist_cuda.histogram_multi): one feature whose
bin is the leaf id, summed in 64-bit fixed point and rounded once to f32,
so they do not depend on the order of the rows and a refit repeats bit for
bit (float atomics would not).  The JAX package sums in f32 scatter order;
the two agree within 1e-6.

Semantics, the JAX package's:

* the score starts at 0 over the export-form trees (the init score folded
  into the first tree of each class), as ``Booster.refit`` runs on a model
  text round trip;
* a leaf no fresh row reaches (sum of hessians 0) keeps its value;
* multiclass tree t renews against class t % k's gradient column;
* sample weights enter through the objective's gradients when given.

``fleet_refit_leaves`` refits B one-tree-an-iteration models over one
shared batch (a FleetBooster's lanes) in one call with one read.

Envelope: constant leaves, no random-forest averaging; an ineligible model
raises ContinualError.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..basic import LightGBMError
from ..ops import predict as predict_ops
from ..ops.hist_cuda import histogram_multi
from ..utils import sanitizer as _san


class ContinualError(LightGBMError):
    """An operation outside the continual runtime's envelope."""


def make_refit_entry(objective, decay: float, lam2: float, k: int = 1):
    """The refit of one (objective, decay, lambda_l2, trees an iteration):
    ``run(leaf_value (T, L) f32, shrinkage (T,) f32, leaves (N, T) i64,
    label, weight=None) -> (T, L) f32`` renewed leaf tables, on the
    tensors' device (module docstring)."""
    # f32 constants, as python floats (exact): torch applies them in f32
    decay_f = float(np.float32(decay))
    keep_f = float(np.float32(1.0 - float(decay)))
    lam2_f = float(np.float32(lam2))
    eps_f = float(np.float32(1e-15))

    def run(leaf_value, shrinkage, leaves, label, weight=None):
        n_tree, n_leaf = leaf_value.shape
        n = leaves.shape[0]
        dev = leaf_value.device
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        slot = torch.zeros(n, dtype=torch.int32, device=dev)
        score = torch.zeros((n,) if k == 1 else (n, k), dtype=torch.float32, device=dev)
        out = []
        for t in range(n_tree):
            g, h = objective.get_gradients(score, label, weight)
            if k > 1:
                g, h = g[:, t % k].contiguous(), h[:, t % k].contiguous()
            leaf = leaves[:, t]
            # per-leaf sums: one feature whose bin is the leaf (B1)
            sums = histogram_multi(leaf.to(torch.int16)[:, None].contiguous(),
                                   g.float().contiguous(), h.float().contiguous(),
                                   ones, slot, 0, 1, n_leaf)[0]
            sum_g, sum_h = sums[0, 0], sums[1, 0]
            lv = leaf_value[t]
            new = -sum_g / (sum_h + lam2_f + eps_f) * shrinkage[t]
            lv_new = torch.where(sum_h > 0, decay_f * lv + keep_f * new, lv)
            out.append(lv_new)
            if k == 1:
                score = score + lv_new[leaf]
            else:
                score[:, t % k] += lv_new[leaf]
        return torch.stack(out)

    return run


def refit_eligible(gbdt) -> Optional[str]:
    """None where the device refit applies, else the reason it does not."""
    if gbdt.average_output:
        return "random-forest ensembles renew against averaged scores"
    s = gbdt._packed(0, -1)
    if s is None:
        return "the ensemble is empty"
    if s["linear"]:
        return ("linear leaves carry per-leaf linear terms a leaf-value refit "
                "would drop")
    return None


def _traverse(gbdt, s, x: torch.Tensor) -> torch.Tensor:
    """(N, T) i64 leaf of every row in every tree of the pack ``s``."""
    walk = predict_ops.walk_args(s["walk"])
    return torch.cat([predict_ops.predict_leaf_values(xs, **walk)
                      for xs in gbdt._chunks(x, len(s["trees"]))]).long()


def _tables(trees, device):
    """(T, L) f32 leaf values (zero padded) and (T,) f32 shrinkages."""
    n_leaf = max(t.num_leaves for t in trees)
    lv = np.zeros((len(trees), n_leaf), np.float32)
    for i, t in enumerate(trees):
        lv[i, :t.num_leaves] = np.asarray(t.leaf_value, np.float32)
    shr = np.asarray([t.shrinkage for t in trees], np.float32)
    return torch.as_tensor(lv, device=device), torch.as_tensor(shr, device=device)


def _write_back(gbdt, new_lv: np.ndarray, v0: int, what: str) -> None:
    """The renewed tables into the host trees, under the pack lock with the
    version check: the export form's first tree of each class carries the
    init score, which a delta-form model keeps apart."""
    k = gbdt.num_tree_per_iteration
    inits = [float(v) for v in (gbdt.init_scores or [0.0])]
    with gbdt._plock():
        if gbdt._pack_version != v0:
            raise ContinualError(
                f"{what}: the ensemble changed while the refit ran (pack version "
                f"{v0} -> {gbdt._pack_version}); the write-back was aborted and "
                "the model is unchanged")
        for i, t in enumerate(gbdt.models):
            vals = new_lv[i, :t.num_leaves].astype(np.float64)
            if i < k and inits[i % k]:
                vals = vals - inits[i % k]
            t.leaf_value = vals
        gbdt._invalidate_pred_cache("continual_refit")


def _f32(v, device) -> Optional[torch.Tensor]:
    return None if v is None else torch.as_tensor(np.asarray(v, np.float32), device=device)


def refit_leaves(gbdt, X: np.ndarray, label: np.ndarray, *,
                 weight: Optional[np.ndarray] = None, entry=None) -> int:
    """Refit ``gbdt``'s leaf values on ``(X, label)`` on its device, with
    one read of the renewed tables; writes them into the host trees and
    bumps the pack version.  ``entry``: a make_refit_entry callable (the
    runner's), else one is made.  Returns the rows used."""
    why = refit_eligible(gbdt)
    if why is not None:
        raise ContinualError(f"device refit does not apply: {why}")
    k = gbdt.num_tree_per_iteration
    if entry is None:
        entry = make_refit_entry(gbdt.objective, float(gbdt.cfg.refit_decay_rate),
                                 float(gbdt.cfg.lambda_l2), k=k)
    X = np.asarray(X, np.float64)
    label = np.asarray(label, np.float64).ravel()
    if X.shape[0] != len(label):
        raise ValueError(f"refit_leaves: {X.shape[0]} rows but {len(label)} labels")
    if weight is not None and len(np.ravel(weight)) != len(label):
        raise ValueError(f"refit_leaves: {len(label)} rows but "
                         f"{len(np.ravel(weight))} weights")
    v0 = gbdt._pack_version
    s = gbdt._packed(0, -1)
    dev = gbdt.device
    lv0, shrink = _tables(s["trees"], dev)
    leaves = _traverse(gbdt, s, torch.as_tensor(np.asarray(X, np.float32), device=dev))
    _san.record_dispatch()
    out = entry(lv0, shrink, leaves, _f32(label, dev),
                _f32(None if weight is None else np.ravel(weight), dev))
    _write_back(gbdt, np.asarray(_san.sync_pull(out), np.float64), v0, "refit_leaves")
    return X.shape[0]


def _lane_gbdt(model):
    gbdt = getattr(model, "_gbdt", model)
    if not hasattr(gbdt, "_packed"):
        raise ContinualError(f"fleet_refit_leaves: {type(model).__name__} is not a "
                             "Booster or GBDT lane")
    return gbdt


def fleet_refit_leaves(models, X: np.ndarray, labels: np.ndarray, *,
                       weights: Optional[np.ndarray] = None) -> int:
    """Refit B one-tree-an-iteration models (a FleetBooster, or a list of
    Boosters over the same features) on the shared ``X`` with (B, n)
    ``labels`` (and ``weights``), in one call with one read of all the
    renewed tables; each lane's result is its ``refit_leaves``' bit for
    bit.  Returns the rows used."""
    if hasattr(models, "boosters"):  # a FleetBooster
        models = models.boosters()
    lanes: List = [_lane_gbdt(m) for m in models]
    if not lanes:
        raise ContinualError("fleet_refit_leaves: no models")
    for i, g in enumerate(lanes):
        why = refit_eligible(g)
        if why is None and g.num_tree_per_iteration != 1:
            why = "the batched refit takes one tree an iteration"
        if why is not None:
            raise ContinualError(f"device refit does not apply to fleet lane {i}: {why}")
    X = np.asarray(X, np.float64)
    labels = np.asarray(labels, np.float64)
    n = X.shape[0]
    if labels.shape != (len(lanes), n):
        raise ValueError(f"fleet_refit_leaves: labels must be ({len(lanes)}, {n}), "
                         f"got {labels.shape}")
    if weights is not None and np.shape(weights) != labels.shape:
        raise ValueError(f"fleet_refit_leaves: weights must match labels "
                         f"{labels.shape}, got {np.shape(weights)}")
    dev = lanes[0].device
    x = torch.as_tensor(np.asarray(X, np.float32), device=dev)
    outs, versions = [], []
    for i, g in enumerate(lanes):
        versions.append(g._pack_version)
        s = g._packed(0, -1)
        lv0, shrink = _tables(s["trees"], dev)
        entry = make_refit_entry(g.objective, float(g.cfg.refit_decay_rate),
                                 float(g.cfg.lambda_l2))
        _san.record_dispatch()
        outs.append(entry(lv0, shrink, _traverse(g, s, x), _f32(labels[i], dev),
                          None if weights is None else _f32(weights[i], dev)))
    width = max(o.shape[1] for o in outs)
    flat = torch.cat([torch.nn.functional.pad(o, (0, width - o.shape[1])).reshape(-1)
                      for o in outs])
    host = np.asarray(_san.sync_pull(flat), np.float64)  # the one read
    off = 0
    for i, (g, o) in enumerate(zip(lanes, outs)):
        size = o.shape[0] * width
        _write_back(g, host[off:off + size].reshape(o.shape[0], width), versions[i],
                    f"fleet_refit_leaves lane {i}")
        off += size
    return n
