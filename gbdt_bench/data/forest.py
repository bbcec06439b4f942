"""A seeded ensemble at a trained model's shape, written as LightGBM v4 text.

The prediction cell scores a model that no training run made, so that the
cell depends on the traversal only.  Trees are grown leaf-wise at random over
a seeded sample of the rows they will score: each step splits, in every tree
at once, a leaf drawn with probability proportional to its rows, on a random
feature, at a threshold drawn at a uniform quantile in [0.05, 0.95] of that
leaf's values; a split that would leave a child under ``min_rows`` sample rows
is not made.  Missing values go the way of a seeded default direction.  Leaf
values are seeded normals.  All of it runs as a few hundred batched torch
calls on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .tabular import generator

DEFAULT_LEFT = 2  # decision_type bit 1
MISSING_NAN = 2 << 2  # decision_type bits 2-3: missing type NaN


Q_LO, Q_HI = 0.05, 0.95  # the range of the quantile a threshold is drawn at


def grow(X: torch.Tensor, trees: int, leaves: int, seed: int, *,
         min_rows: int, leaf_scale: float, max_depth: int) -> dict:
    """Grow ``trees`` random trees of up to ``leaves`` leaves over the rows
    of ``X`` (f32, (R, F), on the device).  Returns numpy arrays, one row a
    tree, in LightGBM's node numbering (internal nodes 0.., leaf l as ~l).
    No leaf is split below ``max_depth``: with hundreds of trees the
    deepest reaches it whatever the seed, so every seed's walk is as long.
    Each threshold is the leaf's value at the drawn quantile, a float32
    number."""
    dev = X.device
    R, F = X.shape
    T, M = trees, leaves - 1
    g = generator(seed, dev)
    leaf_of = torch.zeros((T, R), dtype=torch.int64, device=dev)
    n_leaves = torch.ones(T, dtype=torch.int64, device=dev)
    feat = torch.zeros((T, M), dtype=torch.int64, device=dev)
    thr = torch.zeros((T, M), dtype=torch.float64, device=dev)
    dleft = torch.zeros((T, M), dtype=torch.bool, device=dev)
    left = torch.zeros((T, M), dtype=torch.int64, device=dev)
    right = torch.zeros((T, M), dtype=torch.int64, device=dev)
    # the node above each leaf, and whether the leaf is its left child
    parent = torch.full((T, leaves), -1, dtype=torch.int64, device=dev)
    is_left = torch.zeros((T, leaves), dtype=torch.bool, device=dev)
    depth = torch.zeros((T, leaves), dtype=torch.int64, device=dev)
    t_idx = torch.arange(T, device=dev)
    rows = torch.arange(R, device=dev)
    for _ in range(2 * leaves):  # a split can fail; at most as many again
        growing = n_leaves < leaves
        if not bool(growing.any()):
            break
        counts = torch.zeros((T, leaves), dtype=torch.float32, device=dev)
        counts.scatter_add_(1, leaf_of, torch.ones_like(leaf_of, dtype=torch.float32))
        eligible = (counts >= 2 * min_rows) & (depth < max_depth)
        p = torch.where(eligible, counts, 0.0)
        ok = growing & eligible.any(1)
        p[~ok, 0] = 1.0  # a finished tree draws a dummy leaf
        lf = torch.multinomial(p, 1, generator=g)[:, 0]
        f = torch.randint(0, F, (T,), generator=g, device=dev)
        q = Q_LO + (Q_HI - Q_LO) * torch.rand(T, generator=g, device=dev)
        dl = torch.rand(T, generator=g, device=dev) < 0.5
        v = X[rows[None, :], f[:, None]]  # (T, R)
        member = leaf_of == lf[:, None]
        known = member & ~torch.isnan(v)
        m = known.sum(1)
        srt = torch.sort(torch.where(known, v, float("inf")), dim=1).values
        k = torch.minimum((q * m.float()).long().clamp(min=1), (m - 1).clamp(min=1))
        th = srt[t_idx, k - 1]
        go_left = torch.where(torch.isnan(v), dl[:, None], v <= th[:, None]) & member
        n_left = go_left.sum(1)
        n_right = member.sum(1) - n_left
        ok = ok & (n_left >= min_rows) & (n_right >= min_rows) & (m >= 2)
        th = th.double()
        node = n_leaves - 1  # the new internal node's index
        new_leaf = n_leaves  # the right child's leaf index
        tt, nn = t_idx[ok], node[ok]
        feat[tt, nn] = f[ok]
        thr[tt, nn] = th[ok]
        dleft[tt, nn] = dl[ok]
        # the split leaf's parent now points at the new node
        par, lft = parent[tt, lf[ok]], is_left[tt, lf[ok]]
        has_par = par >= 0
        left[tt[has_par & lft], par[has_par & lft]] = nn[has_par & lft]
        right[tt[has_par & ~lft], par[has_par & ~lft]] = nn[has_par & ~lft]
        left[tt, nn] = ~lf[ok]
        right[tt, nn] = ~new_leaf[ok]
        parent[tt, lf[ok]] = nn
        is_left[tt, lf[ok]] = True
        parent[tt, new_leaf[ok]] = nn
        is_left[tt, new_leaf[ok]] = False
        d = depth[tt, lf[ok]] + 1
        depth[tt, lf[ok]] = d
        depth[tt, new_leaf[ok]] = d
        moved = (~go_left) & member & ok[:, None]
        leaf_of = torch.where(moved, new_leaf[:, None], leaf_of)
        n_leaves = n_leaves + ok.long()
    counts = torch.zeros((T, leaves), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, leaf_of, torch.ones_like(leaf_of))
    values = leaf_scale * torch.randn((T, leaves), generator=g, device=dev,
                                      dtype=torch.float64)
    return dict(num_leaves=n_leaves.cpu().numpy(), split_feature=feat.cpu().numpy(),
                threshold=thr.cpu().numpy(), default_left=dleft.cpu().numpy(),
                left_child=left.cpu().numpy(), right_child=right.cpu().numpy(),
                leaf_value=values.cpu().numpy(), leaf_count=counts.cpu().numpy())


def depths(forest: dict) -> np.ndarray:
    """Depth of every leaf of every tree (the root's children at 1)."""
    out = []
    for t in range(len(forest["num_leaves"])):
        L = int(forest["num_leaves"][t])
        if L <= 1:
            out.append(0)
            continue
        stack = [(0, 0)]
        while stack:
            node, d = stack.pop()
            for child in (forest["left_child"][t][node], forest["right_child"][t][node]):
                if child < 0:
                    out.append(d + 1)
                else:
                    stack.append((int(child), d + 1))
    return np.asarray(out)


def _join(values, fmt: str) -> str:
    return " ".join(fmt.format(v) for v in values)


def model_text(forest: dict, num_features: int) -> str:
    """LightGBM v4 model text of a binary model (sigmoid 1) over
    ``num_features`` numerical columns."""
    blocks = []
    for t in range(len(forest["num_leaves"])):
        L = int(forest["num_leaves"][t])
        M = L - 1
        dt = [MISSING_NAN | (DEFAULT_LEFT if d else 0) for d in forest["default_left"][t][:M]]
        counts = forest["leaf_count"][t][:L]
        lines = [f"Tree={t}", f"num_leaves={L}", "num_cat=0",
                 "split_feature=" + _join(forest["split_feature"][t][:M], "{:d}"),
                 "split_gain=" + _join([1.0] * M, "{:g}"),
                 "threshold=" + _join(forest["threshold"][t][:M], "{:.17g}"),
                 "decision_type=" + _join(dt, "{:d}"),
                 "left_child=" + _join(forest["left_child"][t][:M], "{:d}"),
                 "right_child=" + _join(forest["right_child"][t][:M], "{:d}"),
                 "leaf_value=" + _join(forest["leaf_value"][t][:L], "{:.17g}"),
                 "leaf_weight=" + _join(counts, "{:d}"),
                 "leaf_count=" + _join(counts, "{:d}"),
                 "internal_value=" + _join([0] * M, "{:d}"),
                 "internal_weight=" + _join([0] * M, "{:d}"),
                 "internal_count=" + _join([0] * M, "{:d}"),
                 "is_linear=0", "shrinkage=1", ""]
        blocks.append("\n".join(lines))
    names = [f"Column_{j}" for j in range(num_features)]
    header = ["tree", "version=v4", "num_class=1", "num_tree_per_iteration=1",
              "label_index=0", f"max_feature_idx={num_features - 1}",
              "objective=binary sigmoid:1", "feature_names=" + " ".join(names),
              "feature_infos=" + " ".join(["[-1e+308:1e+308]"] * num_features),
              "tree_sizes=" + " ".join(str(len(b) + 1) for b in blocks), ""]
    return ("\n".join(header) + "\n" + "\n".join(blocks)
            + "\nend of trees\n\nparameters:\n[objective: binary]\nend of parameters\n")


def log_uniform_sizes(count: int, lo: int, hi: int, seed: int) -> np.ndarray:
    """``count`` call sizes, log-uniform in [lo, hi], from a fixed seed."""
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(math.log(lo), math.log(hi), count)).astype(np.int64)
