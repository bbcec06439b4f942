"""Plain reference of one boosting iteration of LightGBM's binary objective.

Everything is float64 torch on whatever device holds the reference's bins;
nothing here imports the port.  Given binned rows (``binning.py``), the
labels, a score and one tree of the model text, it recomputes:

  * gradients: p = sigmoid(score), g = p - y, h = p (1 - p) (LightGBM's
    binary logloss with sigmoid 1, labels {0, 1});
  * each internal node's histogram of (g, h, rows) over its rows, routed by
    the tree's own splits (the root from all rows; of two children, the
    smaller from its rows and the other as the parent's less it);
  * each node's best split gain over every (feature, threshold bin, side of
    the NaN bin) that leaves ``min_data_in_leaf`` rows and
    ``min_sum_hessian_in_leaf`` hessian on each side, with LightGBM's gain
    G_L^2 / (H_L + eps) + G_R^2 / (H_R + eps) - G^2 / (H + eps) (no L1 or
    L2; eps = 1e-15), against the gain of the split the tree made;
  * each leaf's value, -lr * G / (H + eps) (plus the init score in the
    first tree), against the tree's;
  * the binary logloss of a score.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

KEPSILON = 1e-15


def gradients(score: torch.Tensor, label: torch.Tensor):
    p = torch.sigmoid(score)
    return p - label, p * (1.0 - p)


def init_score(label: torch.Tensor) -> float:
    """LightGBM's BoostFromScore for binary: the log-odds of the mean label."""
    p = float(label.double().mean())
    p = min(max(p, KEPSILON), 1.0 - KEPSILON)
    return math.log(p / (1.0 - p))


def logloss(score: torch.Tensor, label: torch.Tensor) -> float:
    # -log sigmoid(s) = softplus(-s); -log(1 - sigmoid(s)) = softplus(s)
    s = score.double()
    y = label.double()
    loss = y * torch.nn.functional.softplus(-s) + (1 - y) * torch.nn.functional.softplus(s)
    return float(loss.mean())


def threshold_bins(tree, bounds: List[np.ndarray]) -> np.ndarray:
    """Each split's threshold as a bin of the reference's bounds; -1 where
    the threshold is none of them (a split the reference cannot place)."""
    out = np.full(len(tree.threshold), -1, dtype=np.int64)
    for i, (f, t) in enumerate(zip(tree.split_feature, tree.threshold)):
        hit = np.flatnonzero(bounds[int(f)] == t)
        if len(hit):
            out[i] = int(hit[0])
    return out


def go_left(bins_col: torch.Tensor, thr_bin, default_left, nan_bin) -> torch.Tensor:
    """Rows of one split that go left, from their bins in its feature."""
    return torch.where(bins_col == nan_bin, default_left, bins_col <= thr_bin)


class Routed:
    """Rows routed through one tree, level by level, from the reference's
    bins: ``node`` per row (>= 0 internal, ~leaf at a leaf)."""

    def __init__(self, bins: torch.Tensor, tree, thr_bin: np.ndarray, nan_bin: torch.Tensor):
        dev = bins.device
        self.bins = bins
        M = tree.num_leaves - 1
        self.feature = torch.as_tensor(tree.split_feature, device=dev)
        self.thr = torch.as_tensor(thr_bin, device=dev)
        self.dl = torch.as_tensor(tree.default_left, device=dev)
        self.left = torch.as_tensor(tree.left_child, device=dev)
        self.right = torch.as_tensor(tree.right_child, device=dev)
        self.nan_bin = nan_bin
        self.M = M

    def step(self, node: torch.Tensor) -> torch.Tensor:
        """One level: rows at internal nodes move to a child."""
        live = node >= 0
        nd = node.clamp(min=0)
        f = self.feature[nd]
        b = self.bins.gather(1, f[:, None])[:, 0].long()
        left = go_left(b, self.thr[nd], self.dl[nd], self.nan_bin[f])
        nxt = torch.where(left, self.left[nd], self.right[nd])
        return torch.where(live, nxt, node)

    def leaves(self, count_nodes: bool = False):
        """Each row's leaf, and (``count_nodes``) the rows of each internal
        node."""
        N = self.bins.shape[0]
        dev = self.bins.device
        if self.M <= 0:
            return torch.zeros(N, dtype=torch.int64, device=dev), None
        node = torch.zeros(N, dtype=torch.int64, device=dev)
        counts = torch.zeros(self.M, dtype=torch.int64, device=dev) if count_nodes else None
        while True:
            live = node >= 0
            if not bool(live.any()):
                break
            if count_nodes:
                counts += torch.bincount(node[live], minlength=self.M)
            node = self.step(node)
        return ~node, counts


def _hist(bins: torch.Tensor, rows: torch.Tensor, slot: torch.Tensor, n_slots: int,
          g: torch.Tensor, h: torch.Tensor, B: int, elems: int = 1 << 25) -> torch.Tensor:
    """(n_slots, F, B, 3) sums of (g, h, 1) of ``rows`` into their slots."""
    F = bins.shape[1]
    K = n_slots * F * B
    out = torch.zeros((3, K), dtype=torch.float64, device=bins.device)
    fb = torch.arange(F, device=bins.device) * B
    step = max(1, elems // max(F, 1))
    for lo in range(0, rows.shape[0], step):
        r = rows[lo:lo + step]
        key = (slot[lo:lo + step, None] * (F * B) + fb[None, :] + bins[r].long()).reshape(-1)
        out[0] += torch.bincount(key, g[r][:, None].expand(-1, F).reshape(-1), minlength=K)
        out[1] += torch.bincount(key, h[r][:, None].expand(-1, F).reshape(-1), minlength=K)
        out[2] += torch.bincount(key, minlength=K).double()
    return out.T.reshape(n_slots, F, B, 3)


def split_gains(hist: torch.Tensor, nb: torch.Tensor, nan_bin: torch.Tensor,
                min_data: float, min_hess: float):
    """Gains (F, B, 2) of every candidate of one node's histogram (F, B, 3):
    threshold bin t (bins <= t left), NaN rows right (0) or left (1); the
    first with -inf where the constraints forbid the split, the second
    without them (a chosen split is judged by its gain alone: a child's
    hessian within rounding of the limit may fall either side of it)."""
    F, B, _ = hist.shape
    dev = hist.device
    b_idx = torch.arange(B, device=dev)
    is_nan = b_idx[None, :] == nan_bin[:, None]
    nm = torch.where(is_nan[..., None], 0.0, hist)
    miss = torch.where(is_nan[..., None], hist, 0.0).sum(1)  # (F, 3)
    cum = torch.cumsum(nm, 1)
    tot = hist[0].sum(0)  # every row is in some bin of feature 0
    last_nm = nb - torch.where(nan_bin >= 0, 2, 1)
    valid = b_idx[None, :] < last_nm[:, None]
    parent = tot[0] ** 2 / (tot[1] + KEPSILON)
    masked, raw = [], []
    for add in (torch.zeros_like(miss), miss):
        L = cum + add[:, None, :]
        R = tot - L
        ok = (valid & (L[..., 2] >= min_data) & (R[..., 2] >= min_data)
              & (L[..., 1] >= min_hess) & (R[..., 1] >= min_hess))
        gain = (L[..., 0] ** 2 / (L[..., 1] + KEPSILON)
                + R[..., 0] ** 2 / (R[..., 1] + KEPSILON) - parent)
        raw.append(gain)
        masked.append(torch.where(ok, gain, -math.inf))
    return torch.stack(masked, -1), torch.stack(raw, -1)


def check_tree(bins, label, score, tree, thr_bin, nb, nan_bin, *, lr: float,
               init: float, min_data: float, min_hess: float) -> Dict[str, float]:
    """Judge one tree grown at ``score``: the worst split-gain gap
    (best - chosen) / best over its internal nodes, the worst leaf-value gap
    |tree - reference| / max(|reference|, median |reference|), and the
    tree's leaf of every row."""
    dev = bins.device
    g, h = gradients(score, label)
    N, F = bins.shape
    B = int(nb.max())
    M = tree.num_leaves - 1
    router = Routed(bins, tree, thr_bin, nan_bin)
    if (thr_bin < 0).any():
        return dict(gain_gap=math.inf, leaf_gap=math.inf), None
    gain_gap = 0.0
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    if M > 0:
        all_rows = torch.arange(N, device=dev)
        hists = {0: _hist(bins, all_rows, torch.zeros(N, dtype=torch.int64, device=dev),
                          1, g, h, B)[0]}
        level = [0]
        left = tree.left_child
        right = tree.right_child
        while level:
            for n in level:
                gains, raw = split_gains(hists[n], nb, nan_bin, min_data, min_hess)
                best = float(gains.max())
                f, t = int(tree.split_feature[n]), int(thr_bin[n])
                side = int(bool(tree.default_left[n]))
                chosen = float(raw[f, t, side])
                if not best > 0:
                    gain_gap = math.inf
                else:
                    gain_gap = max(gain_gap, (best - chosen) / best)
            node = router.step(node)
            # the children of this level's nodes, and their rows
            children = [(int(left[n]), int(right[n]), n) for n in level]
            direct, derive = [], []
            counts = torch.bincount(torch.where(node >= 0, node, M + (~node)),
                                    minlength=2 * M + 1).cpu().numpy()

            def rows_of(c):
                return counts[c] if c >= 0 else counts[M + ~c]
            for a, b, p in children:
                if a < 0 and b < 0:
                    continue
                small, large = (a, b) if rows_of(a) <= rows_of(b) else (b, a)
                direct.append(small)
                if large >= 0:
                    derive.append((large, small, p))
            key = torch.where(node >= 0, node, M + (~node))
            slot_of = torch.full((2 * M + 1,), -1, dtype=torch.int64, device=dev)
            idx = [c if c >= 0 else M + ~c for c in direct]
            slot_of[torch.as_tensor(idx, dtype=torch.int64, device=dev)] = torch.arange(
                len(idx), device=dev)
            slot = slot_of[key]
            rows = torch.nonzero(slot >= 0)[:, 0]
            got = _hist(bins, rows, slot[rows], len(idx), g, h, B) if idx else None
            new = {}
            for i, c in enumerate(direct):
                new[c] = got[i]
            for large, small, p in derive:
                new[large] = hists[p] - new[small]
            hists = {c: v for c, v in new.items() if c >= 0}
            level = sorted(hists)
    leaf = ~node if M > 0 else torch.zeros(N, dtype=torch.int64, device=dev)
    L = tree.num_leaves
    G = torch.zeros(L, dtype=torch.float64, device=dev).index_add_(0, leaf, g)
    H = torch.zeros(L, dtype=torch.float64, device=dev).index_add_(0, leaf, h)
    ref = (-lr * G / (H + KEPSILON) + init).cpu().numpy()
    scale = max(float(np.median(np.abs(ref))), 1e-300)
    got = np.asarray(tree.leaf_value, np.float64)
    leaf_gap = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), scale)))
    return dict(gain_gap=gain_gap, leaf_gap=leaf_gap), leaf
