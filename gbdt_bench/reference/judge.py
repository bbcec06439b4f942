"""The comparisons that decide ``correct``: the port's outputs against the
plain reference, recomputed from the same raw inputs.

Training (``judge_training``), over the model the run produced:
  * ``bin_mismatch``: features whose bounds differ from the reference's, plus
    binned cells that differ, plus splits whose threshold is no reference
    bound (exact: 0);
  * ``trees_missing``: iterations run that left no tree (exact: 0);
  * ``loss_gap``: the worst relative gap between the port's training
    logloss after each followed step and the reference's, from the port's
    trees routed by the reference;
  * ``gain_gap``: the worst (best - chosen) / best split gain over the
    internal nodes of the followed trees and of one tree the window grew
    (a fixed index, so that a faster port is judged on the same tree), each
    at the score of the trees before it;
  * ``leaf_gap``: the worst leaf-value gap of the same trees, against each
    tree's median leaf;
  * ``predict_gap`` (``judge_held_out``): the worst gap between the port's
    ``predict`` of the held-out rows with the model and the reference's
    probability from a walk of the model text.
Prediction (``judge_predictions``): ``predict_gap``, the worst gap between
an answer the port returned in the window and the reference's probability
for its row.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import binning, gbdt, model_text


def judge_training(*, X: np.ndarray, y: np.ndarray, text: str,
                   losses: Sequence[float], iterations: int, port_bins: torch.Tensor,
                   port_bounds: List[np.ndarray], params: dict, device, judge_tree: int,
                   count_trees: Sequence[int] = ()):
    """Judges the followed trees and tree ``judge_tree`` (the last where the
    model is shorter).  Returns (checks, node_rows): node_rows[t] is a
    function of a node (internal i >= 0, leaf ~l) giving its rows in tree
    t, for t in ``count_trees``."""
    N, F = X.shape
    Xd = torch.from_numpy(X).to(device)
    yd = torch.from_numpy(np.asarray(y, np.float32)).to(device).double()
    idx = binning.sample_rows(N, int(params.get("bin_construct_sample_cnt", 200000)),
                              int(params.get("data_random_seed", 1)))
    sample = (Xd if idx is None else Xd[torch.as_tensor(idx, device=device)]).double()
    bounds, has_nan = binning.bin_bounds(sample, int(params["max_bin"]),
                                         int(params.get("min_data_in_bin", 3)))
    del sample
    bins = binning.transform(Xd, bounds, has_nan)
    del Xd
    nb, nan_bin = binning.tables(bounds, has_nan, device)
    mismatch = sum(1 for a, b in zip(bounds, port_bounds)
                   if len(a) != len(b) or not np.array_equal(a, np.asarray(b, np.float64)))
    mismatch += abs(len(bounds) - len(port_bounds))
    if tuple(port_bins.shape) != tuple(bins.shape):
        mismatch = math.inf
    else:
        for lo in range(0, N, 1 << 22):
            mismatch += int((port_bins[lo:lo + (1 << 22)].to(device).long()
                             != bins[lo:lo + (1 << 22)].long()).sum())
    trees = model_text.parse(text)
    checks = dict(bin_mismatch=float(mismatch),
                  trees_missing=float(abs(iterations - len(trees))))
    lr = float(params["learning_rate"])
    init = gbdt.init_score(yd)
    follow = len(losses)
    judged = set(range(min(follow, len(trees))))
    if trees:
        judged.add(min(judge_tree, len(trees) - 1))
    # the first tree grows at the init score and carries it in its leaves
    score = torch.full((N,), init, dtype=torch.float64, device=device)
    gain_gap = leaf_gap = loss_gap = 0.0 if trees else math.inf
    node_rows = {}
    for t, tree in enumerate(trees):
        thr = gbdt.threshold_bins(tree, bounds)
        checks["bin_mismatch"] += float((thr < 0).sum())
        if t in judged:
            res, leaf = gbdt.check_tree(
                bins, yd, score, tree, thr, nb, nan_bin, lr=lr,
                init=init if t == 0 else 0.0,
                min_data=float(params["min_data_in_leaf"]),
                min_hess=float(params["min_sum_hessian_in_leaf"]))
            gain_gap = max(gain_gap, res["gain_gap"])
            leaf_gap = max(leaf_gap, res["leaf_gap"])
        if t in count_trees or t not in judged:
            leaf2, counts = gbdt.Routed(bins, tree, thr, nan_bin).leaves(
                count_nodes=t in count_trees)
            leaf = leaf2 if t not in judged else leaf
            if counts is not None:
                inner = counts.cpu().numpy()
                leaves = torch.bincount(leaf2, minlength=tree.num_leaves).cpu().numpy()
                node_rows[t] = (lambda i, a=inner, b=leaves: int(a[i]) if i >= 0 else int(b[~i]))
        if leaf is None:
            leaf = torch.zeros(N, dtype=torch.int64, device=device)
        score += torch.as_tensor(tree.leaf_value, device=device)[leaf] - (init if t == 0 else 0.0)
        if t < follow:
            ref = gbdt.logloss(score, yd)
            loss_gap = max(loss_gap, abs(float(losses[t]) - ref) / ref)
    if len(trees) < follow:
        loss_gap = math.inf
    checks.update(loss_gap=loss_gap, gain_gap=gain_gap, leaf_gap=leaf_gap)
    return checks, node_rows


def reference_probabilities(trees, X: torch.Tensor, dtype=torch.float64) -> np.ndarray:
    """The reference's answers (probabilities) for rows X; ``dtype`` lower
    than float64 is the control."""
    raw = model_text.raw_scores(trees, X, dtype=dtype)
    return torch.sigmoid(raw).double().cpu().numpy()


def judge_held_out(text: str, X: np.ndarray, answers: np.ndarray, device
                   ) -> Dict[str, float]:
    """The port's ``predict`` of held-out rows ``X`` against the reference's
    walk of the model text ``text``."""
    want = reference_probabilities(model_text.parse(text), torch.from_numpy(X).to(device))
    return judge_predictions({0: answers}, {0: want})


def judge_predictions(answers: Dict[int, np.ndarray], reference: Dict[int, np.ndarray]
                      ) -> Dict[str, float]:
    if not answers:
        return {"predict_gap": math.inf}
    gap = 0.0
    for i, got in answers.items():
        want = reference[i]
        if np.shape(got) != np.shape(want):
            return {"predict_gap": math.inf}
        gap = max(gap, float(np.max(np.abs(np.asarray(got, np.float64) - want))))
    return {"predict_gap": gap}
