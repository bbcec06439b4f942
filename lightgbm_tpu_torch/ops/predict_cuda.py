"""Tree-ensemble traversal: the hand-written Hopper kernel and its plain
version.

The kernel (csrc/predict.cu) replaces no TPU kernel; its source note says
why it was added, what bounds it and how its design answers.  This module
packs a stacked ensemble's nodes into the kernel's table (``node_table``,
once a pack: models/gbdt.py::GBDT._stacked), builds the kernel (nvcc into a
shared library with a plain C interface, loaded with ctypes, at first use),
checks and launches it, and holds the plain version: ops/predict.py's walk
(``leaf_index``) and sum (``leaf_sum``, or ``predict_raw_window`` for a
window of trees onto a base).

Dispatch rule: a CUDA tensor launches the kernel or raises; only a tensor
that lies on the CPU takes the plain version.  No failure is caught and
turned into the plain path.  Kernel and plain version make the same
float32 decisions and add the same leaf values in the same order, so they
agree bit for bit.

The node table (int32 words): one 16-byte record a node, tree t's node j
at record t * M + j (M: the stacked width), then the categorical bitsets.
Word 0 holds the split feature (bits 0-23), the missing type (24-25),
default_left (26) and the categorical flag (27); word 1 the float32
threshold's bits, or for a categorical node the table offset of its bitset
(the word count, then the words); words 2 and 3 the left and right child
(negative: ~leaf).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import predict as predict_ops
from .cuda_build import KernelLibrary, count_launch, stream_ptr
from ..utils.audit_hooks import audited

# launch counts of the kernel wrapper and call counts of the plain version
launches = {"predict_trees": 0}
plain_calls = {"predict_trees": 0}
RECORD_WORDS = 4
FEATURE_BITS = 24
MISS_SHIFT, DEFAULT_LEFT_BIT, CAT_BIT = 24, 26, 27
MAX_CLASSES = 65535  # grid.y


def reset_counts() -> None:
    for d in (launches, plain_calls):
        for k in d:
            d[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lgbt_predict.argtypes = [p, ll, i, p, p, p, i, i, i, i, i, i, p, p, p, p, p]
    lib.lgbt_predict.restype = i


LIBRARY = KernelLibrary("predict.cu", _bind)


def node_table(split_feature: np.ndarray, threshold: np.ndarray,
               default_left: np.ndarray, missing_type: np.ndarray,
               left_child: np.ndarray, right_child: np.ndarray,
               cat: Optional[tuple] = None) -> np.ndarray:
    """The kernel's node table (module docstring) of a stacked ensemble's
    host arrays: (T, M) split_feature, f32 threshold, default_left,
    missing_type, left_child and right_child, and ``cat`` (is_cat,
    cat_base, cat_nwords (T, M), the flat words (W,)) or None.  Returns a
    flat int32 array."""
    t, m = split_feature.shape
    feat = split_feature.astype(np.int64)
    if feat.size and (feat.min() < 0 or feat.max() >= 1 << FEATURE_BITS):
        raise ValueError(f"the traversal kernel takes split features in [0, "
                         f"2^{FEATURE_BITS}), got up to {int(feat.max())}")
    rec = np.empty((t, m, RECORD_WORDS), np.int32)
    meta = (feat | (missing_type.astype(np.int64) & 3) << MISS_SHIFT
            | default_left.astype(np.int64) << DEFAULT_LEFT_BIT)
    rec[..., 1] = np.ascontiguousarray(threshold, np.float32).view(np.int32)
    rec[..., 2] = left_child
    rec[..., 3] = right_child
    sets = []
    if cat is not None:
        is_cat, base, nwords, words = cat
        meta = meta | is_cat.astype(np.int64) << CAT_BIT
        words = np.asarray(words, np.int64).astype(np.uint32).view(np.int32)
        off = t * m * RECORD_WORDS
        where = {}  # (base, nwords) -> the offset of that bitset
        for ti, j in zip(*np.nonzero(is_cat)):
            key = (int(base[ti, j]), int(nwords[ti, j]))
            if key not in where:
                where[key] = off
                sets.append(np.concatenate([[key[1]], words[key[0]:key[0] + key[1]]]))
                off += 1 + key[1]
            rec[ti, j, 1] = where[key]
    rec[..., 0] = meta.astype(np.int64).astype(np.uint32).view(np.int32)
    return np.concatenate([rec.reshape(-1)] + [s.astype(np.int32) for s in sets])


def _check(x, walk, k, tree_lo, window, base, active, counts) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"x must be (N, F) float32, got {tuple(x.shape)} {x.dtype}")
    n, f = x.shape
    if f < walk["features"] or f >= 1 << FEATURE_BITS:
        raise ValueError(f"x has {f} columns; the trees read {walk['features']} "
                         f"(and the kernel takes fewer than 2^{FEATURE_BITS})")
    t, m = walk["split_feature"].shape
    nodes, leaf_value = walk["nodes"], walk["leaf_value"]
    for name, v, dtype, ok in (
            ("nodes", nodes, torch.int32,
             nodes.dim() == 1 and nodes.numel() >= t * m * RECORD_WORDS),
            ("num_leaves", walk["num_leaves"], torch.int32,
             tuple(walk["num_leaves"].shape) == (t,)),
            ("leaf_value", leaf_value, torch.float32,
             leaf_value.dim() == 2 and leaf_value.shape[0] == t),
            ("base", base, torch.float32,
             base is None or tuple(base.shape) == ((n,) if k == 1 else (n, k))),
            ("active", active, torch.bool, active is None or tuple(active.shape) == (n,)),
            ("counts", counts, torch.int64, counts is None or tuple(counts.shape) == (2,))):
        if v is None:
            continue
        if v.dtype != dtype or not ok:
            raise TypeError(f"{name}: {tuple(v.shape)} {v.dtype} does not fit x "
                            f"{tuple(x.shape)}, {t} trees of {m} nodes, k={k}")
        if v.device != x.device or not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}, x's device")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if nodes.data_ptr() % 16:
        raise ValueError("the node table must be 16-byte aligned")
    if not (1 <= k <= MAX_CLASSES and t % k == 0 and tree_lo >= 0 and tree_lo % k == 0
            and window % k == 0 and tree_lo + window <= t):
        raise ValueError(f"trees [{tree_lo}, {tree_lo + window}) of {t} in classes "
                         f"of k={k}: need whole iterations, 1 <= k <= {MAX_CLASSES}")


@audited("predict_trees")
def predict_trees(x: torch.Tensor, walk: dict, k: int = 1, *, tree_lo: int = 0,
                  window: Optional[int] = None, base: Optional[torch.Tensor] = None,
                  active: Optional[torch.Tensor] = None,
                  counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw margins of the rows ``x`` (N, F) f32 over the stacked trees
    ``walk`` (GBDT._stacked): (N,) f32, or (N, k) f32 for ``k`` classes,
    tree i in class i % k, each class its trees' leaf values added in tree
    order from +0.0 (leaf_sum's bits).  The window mode (prediction early
    stopping) takes ``window`` trees from ``tree_lo`` onto ``base`` for the
    rows where ``active`` is set, and gives the other rows ``base``
    (predict_raw_window's bits).  ``counts``, on the card only: an int64[2]
    tensor, zeroed, that the kernel adds the lane-steps its warps issued and
    the rows' leaf depths to (a traced call's).  One launch a call on the
    card, none for no rows."""
    t = walk["num_leaves"].shape[0]
    if ((window is None) != (base is None) or (base is None) != (active is None)
            or (window is None and tree_lo)):
        raise ValueError("tree_lo, window, base and active go together (the window mode)")
    window = t - tree_lo if window is None else window
    if not x.is_cuda:
        if counts is not None:
            raise ValueError("counts are the kernel's: the plain walk has none")
        return predict_trees_plain(x, walk, k, tree_lo=tree_lo, window=window,
                                   base=base, active=active)
    _check(x, walk, k, tree_lo, window, base, active, counts)
    n, f = x.shape
    out = torch.empty((n,) if k == 1 else (n, k), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    m = walk["split_feature"].shape[1]
    with torch.cuda.device(x.device):
        rc = LIBRARY.lib().lgbt_predict(
            x.data_ptr(), n, f, walk["nodes"].data_ptr(), walk["num_leaves"].data_ptr(),
            walk["leaf_value"].data_ptr(), m, walk["leaf_value"].shape[1], int(tree_lo),
            int(tree_lo + window), int(k), int(walk["cat"] is not None),
            None if base is None else base.data_ptr(),
            None if active is None else active.data_ptr(), out.data_ptr(),
            None if counts is None else counts.data_ptr(), stream_ptr(x.device))
    LIBRARY.raise_on(rc, "predict_trees kernel")
    count_launch(launches, "predict_trees")
    return out


def predict_trees_plain(x, walk, k=1, *, tree_lo=0, window=None, base=None, active=None):
    """The plain walk and sum: every tree, or the window mode's trees onto
    ``base``."""
    plain_calls["predict_trees"] += 1
    if base is None:
        return predict_ops.leaf_sum(
            predict_ops.leaf_index(x, **predict_ops.walk_args(walk)), walk["leaf_value"], k)
    return predict_ops.predict_raw_window(x, tree_lo, k=k, window=window, base=base,
                                          active=active, **walk)
