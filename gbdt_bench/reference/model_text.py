"""Plain reader of LightGBM v4 model text, and a traversal of raw rows.

Only what the benchmark's models use: numerical splits (``x <= threshold``
goes left), missing type NaN or none (decision_type bits 2-3: NaN takes the
default direction, bit 1; under type none a NaN reads as 0.0), one tree an
iteration, leaf values with the shrinkage and the first tree's init score
already folded in.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch


@dataclass
class Tree:
    num_leaves: int
    split_feature: np.ndarray
    threshold: np.ndarray
    decision_type: np.ndarray
    left_child: np.ndarray
    right_child: np.ndarray
    leaf_value: np.ndarray

    @property
    def default_left(self) -> np.ndarray:
        return (self.decision_type & 2) != 0

    @property
    def missing_nan(self) -> np.ndarray:
        return ((self.decision_type >> 2) & 3) == 2


def _numbers(kv: dict, key: str, dtype, n: int) -> np.ndarray:
    text = kv.get(key, "").split()
    if len(text) != n:
        raise ValueError(f"{key}: {len(text)} values where {n} were expected")
    return np.asarray([float(t) for t in text], dtype=np.float64).astype(dtype)


def parse(text: str) -> List[Tree]:
    """The trees of a model text, in order."""
    body = text.split("\nend of trees")[0]
    trees = []
    for block in body.split("\nTree=")[1:]:
        kv = {}
        for line in block.splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        if int(kv.get("num_cat", 0)):
            raise ValueError("categorical splits are not read here")
        L = int(kv["num_leaves"])
        M = L - 1
        trees.append(Tree(
            num_leaves=L,
            split_feature=_numbers(kv, "split_feature", np.int64, M),
            threshold=_numbers(kv, "threshold", np.float64, M),
            decision_type=_numbers(kv, "decision_type", np.int64, M),
            left_child=_numbers(kv, "left_child", np.int64, M),
            right_child=_numbers(kv, "right_child", np.int64, M),
            leaf_value=_numbers(kv, "leaf_value", np.float64, L)))
    return trees


def stack(trees: List[Tree], device, dtype=torch.float64) -> dict:
    """The trees as padded (T, M) tables on ``device``; ``dtype`` is that of
    the thresholds and leaf values."""
    T = len(trees)
    M = max(max(t.num_leaves - 1 for t in trees), 1)
    L = M + 1

    def pad(get, width, fill, np_dtype):
        out = np.full((T, width), fill, dtype=np_dtype)
        for i, t in enumerate(trees):
            v = get(t)
            out[i, :len(v)] = v
        return out

    one_leaf = np.asarray([t.num_leaves <= 1 for t in trees])
    return dict(
        feature=torch.as_tensor(pad(lambda t: t.split_feature, M, 0, np.int64), device=device),
        threshold=torch.as_tensor(pad(lambda t: t.threshold, M, 0.0, np.float64),
                                  device=device).to(dtype),
        default_left=torch.as_tensor(pad(lambda t: t.default_left, M, False, bool), device=device),
        missing_nan=torch.as_tensor(pad(lambda t: t.missing_nan, M, False, bool), device=device),
        left=torch.as_tensor(pad(lambda t: t.left_child, M, -1, np.int64), device=device),
        right=torch.as_tensor(pad(lambda t: t.right_child, M, -1, np.int64), device=device),
        value=torch.as_tensor(pad(lambda t: t.leaf_value, L, 0.0, np.float64),
                              device=device).to(dtype),
        one_leaf=torch.as_tensor(one_leaf, device=device))


def raw_scores(trees: List[Tree], X: torch.Tensor, dtype=torch.float64,
               rows_per_chunk: int = 1 << 16, trees_per_chunk: int = 128) -> torch.Tensor:
    """Sum over the trees of each row's leaf value (the raw margin), in
    ``dtype`` (thresholds compared and values summed in it) for rows X
    ((N, F) float32 on the device)."""
    dev = X.device
    out = torch.zeros(X.shape[0], dtype=dtype, device=dev)
    for t0 in range(0, len(trees), trees_per_chunk):
        tab = stack(trees[t0:t0 + trees_per_chunk], dev, dtype)
        T = tab["feature"].shape[0]
        t_idx = torch.arange(T, device=dev)[None, :]
        for lo in range(0, X.shape[0], rows_per_chunk):
            x = X[lo:lo + rows_per_chunk].to(dtype)
            n = x.shape[0]
            node = torch.zeros((n, T), dtype=torch.int64, device=dev)
            node[:, tab["one_leaf"]] = -1  # a one-leaf tree: leaf 0 at once
            r_idx = torch.arange(n, device=dev)[:, None]
            while True:
                live = node >= 0
                if not bool(live.any()):
                    break
                nd = node.clamp(min=0)
                v = x[r_idx, tab["feature"][t_idx, nd]]
                nan = torch.isnan(v)
                go_left = torch.where(
                    nan & tab["missing_nan"][t_idx, nd], tab["default_left"][t_idx, nd],
                    torch.where(nan, 0.0, v) <= tab["threshold"][t_idx, nd])
                nxt = torch.where(go_left, tab["left"][t_idx, nd], tab["right"][t_idx, nd])
                node = torch.where(live, nxt, node)
            vals = tab["value"][t_idx, ~node]
            out[lo:lo + n] += vals.sum(1) if dtype == torch.float64 else _ordered_sum(vals)
    return out


def _ordered_sum(vals: torch.Tensor) -> torch.Tensor:
    """Sum over trees in tree order, rounding in the values' own dtype at
    every addition (as a low-precision accumulator would)."""
    acc = torch.zeros(vals.shape[0], dtype=vals.dtype, device=vals.device)
    for t in range(vals.shape[1]):
        acc = acc + vals[:, t]
    return acc
