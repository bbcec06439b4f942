"""Bytes that one boosting iteration needs, whatever kernels implement it.

Counted from the shapes and the iteration's tree: ``N`` rows, ``F`` features
of ``bin_bytes`` a bin (1 at <= 256 bins), ``B`` bins a feature, and for each
split the rows of the node split and of its two children (as the benchmark
recounts them from the binned rows).  With ``s`` over the splits:

  hist      = (N + sum_s min(left_s, right_s)) * (F * bin_bytes + 8)
              + (1 + splits) * F * B * 12
      the root reads every row's bins and its float32 gradient and hessian;
      each split reads its smaller child's rows (the larger child is the
      parent's histogram less the smaller one's); every histogram built is
      written once, (g, h, count) at 4 bytes each a bin;
  partition = sum_s parent_s * 4 * 2
      each split reads and writes the 4-byte row index of each of its
      parent's rows;
  gradients = N * 16
      each row's score and label are read (4 + 4) and its gradient and
      hessian written (4 + 4);
  score     = N * 12
      each row's leaf index is read (4) and its score read and written
      (4 + 4).

Nothing is counted twice that a kernel happens to read twice, and nothing
here knows which kernel reads what: a redesigned kernel changes the time
that divides these bytes, never the bytes.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

# (parent rows, left rows, right rows) of one split
Split = Tuple[int, int, int]


def hist_bytes(N: int, F: int, B: int, splits: Iterable[Split], bin_bytes: int = 1) -> int:
    splits = list(splits)
    rows = N + sum(min(l, r) for _, l, r in splits)
    return rows * (F * bin_bytes + 8) + (1 + len(splits)) * F * B * 12


def partition_bytes(splits: Iterable[Split]) -> int:
    return sum(p for p, _, _ in splits) * 4 * 2


def gradient_bytes(N: int) -> int:
    return N * 16


def score_bytes(N: int) -> int:
    return N * 12


def iteration_bytes(N: int, F: int, B: int, splits: Iterable[Split],
                    bin_bytes: int = 1) -> Dict[str, int]:
    """Every part of one iteration's needed bytes, and their sum."""
    splits = list(splits)
    parts = dict(hist=hist_bytes(N, F, B, splits, bin_bytes),
                 partition=partition_bytes(splits),
                 gradients=gradient_bytes(N), score=score_bytes(N))
    parts["total"] = sum(parts.values())
    return parts


def splits_of(tree, node_rows) -> list:
    """(parent, left, right) rows of each split of a model-text tree, from
    the rows of each internal node and of each leaf: ``node_rows(i)`` for
    internal node i >= 0, ``node_rows(~l)`` for leaf l."""
    return [(node_rows(i), node_rows(int(tree.left_child[i])),
             node_rows(int(tree.right_child[i])))
            for i in range(tree.num_leaves - 1)]
