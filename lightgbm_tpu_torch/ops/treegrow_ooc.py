"""Out-of-core tree growth: the spill regime of ``out_of_core``.

Counterpart of lightgbm_tpu/ops/treegrow_ooc.py.  The in-memory growers
read the whole (N, F) bin matrix on the device; this grower keeps only the
O(N) vectors there (leaf ids, gradients, masks) and the (L, 3, F, B)
histogram state, and streams the matrix through the card in row chunks
(io/stream.py prefetch_device: two reused pinned staging buffers, a
one-deep upload) once a histogram pass: the root pass, then one pass a
split, which moves the split leaf's rows (an elementwise leaf-id update
from the chunk's split column) and histograms the smaller child.

It is a chunk-streamed mirror of the strict grower (ops/treegrow.py
``grow_tree``) without its constraint envelope: the same best leaf, the
same split search, the same bookkeeping, and histograms that are the
strict grower's bit for bit.  Those come from B1's carried mode
(hist_cuda.histogram_multi_carry): every chunk adds its rows' 64-bit
fixed-point sums into one accumulator the sweep keeps, with the tree's
exponent pair taken from all N rows' gradients, and the f32 conversion
runs once, after the last chunk.  Integer sums are order-free, so any
partition of the rows into chunks gives the in-memory histogram's bits,
and the model text is the in-memory strict grower's.

Reads: the strict grower makes none inside a tree (a step after the last
useful split is a masked no-op); this one reads whether a split remains
once a split (one blocking read a split, as the JAX package's spill
grower does) and stops there, so it sweeps no chunk for a no-op step.

Envelope (models/gbdt.py gates it, as the JAX package does): numerical
and categorical splits, feature_contri, bagging and GOSS row masks,
feature_fraction, max_depth and path smoothing; no monotone, interaction
or forced splits, CEGB, linear leaves, extra_trees or per-node sampling.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..obs import metrics as _obs
from ..utils import sanitizer as _san
from .hist_cuda import CarryAccumulator, fixed_shift_tensor, histogram_multi_carry
from .round_cuda import split_window
from .split import (KMIN_SCORE, BestSplit, SplitParams, find_best_split,
                    leaf_output, leaf_output_smoothed)
from .treegrow import (TreeArrays, _empty_best, _put, _set_best, at, book_tree,
                       empty_tree, final_leaf_values, finish_tree, go_left_of)


def grow_tree_ooc(
    chunks: Callable,  # () -> iterator of (row_lo, rows, (C, F) int16 on the device)
    n: int,
    f: int,
    grad: torch.Tensor,  # (N,) f32
    hess: torch.Tensor,
    row_mask: torch.Tensor,  # (N,) bool
    sample_weight: torch.Tensor,  # (N,) f32
    feature_mask: Optional[torch.Tensor],  # (F,) bool
    num_bins_per_feature: torch.Tensor,
    missing_bin_per_feature: torch.Tensor,
    *,
    num_leaves: int,
    num_bins: int,
    max_depth: int = -1,
    params: SplitParams = SplitParams(),
    categorical_mask: Optional[torch.Tensor] = None,
    feature_contri: Optional[torch.Tensor] = None,
    stats: Optional[dict] = None,
) -> tuple[TreeArrays, torch.Tensor]:
    """Grow one tree over a streamed bin matrix; returns (tree, leaf id per
    row), the strict grower's contract.  ``chunks`` is called once a pass
    and yields the same chunks in the same order each time.  ``stats``
    receives the tree's utils/sanitizer.py counts and {splits, passes,
    chunks}."""
    with _san.DispatchCounter() as counter:
        out = _grow(chunks, n, f, grad, hess, row_mask, sample_weight, feature_mask,
                    num_bins_per_feature, missing_bin_per_feature, num_leaves,
                    num_bins, max_depth, params, categorical_mask, feature_contri)
    tree, leaf_id, tally = out
    if stats is not None:
        stats.update(counter.stats(), retries=0, windows=[], **tally)
    if _obs.enabled():
        _obs.counter("train_ooc_passes_total").inc(tally["passes"])
        _obs.counter("train_ooc_chunks_total").inc(tally["chunks"])
    return tree, leaf_id


def split_chunk(leaf_id, chunk, lo: int, hi: int, s: BestSplit, feat, mb,
                best_leaf, new_leaf, cmask) -> None:
    """A split's partition of one chunk: the rows [lo, hi) of ``best_leaf``
    that the chunk's split column sends right move to ``new_leaf`` (an
    elementwise leaf-id update, in place)."""
    fcol = chunk.index_select(1, feat.reshape(1))[:, 0].to(torch.int32)
    go_left = go_left_of(fcol, mb, s.default_left, s.threshold_bin, *(
        (s.is_cat, s.cat_mask[fcol.long()]) if cmask is not None else ()))
    lid = leaf_id[lo:hi]
    lid.copy_(torch.where((lid == best_leaf) & ~go_left, new_leaf.to(torch.int32),
                          lid))


def _grow(chunks, n, f, grad, hess, row_mask, sample_weight, feature_mask, nbpf,
          mbpf, L, num_bins, max_depth, params, cmask, contri):
    dev = grad.device
    grad = grad.float() * sample_weight
    hess = hess.float() * sample_weight
    shift = fixed_shift_tensor(grad, hess)  # the tree's, from all N rows
    slot = torch.zeros(n, dtype=torch.int32, device=dev)
    idx = torch.arange(L, dtype=torch.int64, device=dev)
    drop = -1
    eps = KMIN_SCORE / 2
    tally = {"splits": 0, "passes": 0, "chunks": 0}

    def sweep(chunk_mask, update=None):
        """One pass: ``update(lo, hi, chunk)`` first moves the chunk's rows
        (the split's leaf-id update), then ``chunk_mask(lo, hi)`` picks the
        rows the histogram sums.  Returns the (1, 3, F, B) histogram."""
        acc = CarryAccumulator(1, f, num_bins, shift, dev)
        out = None
        for lo, m, chunk in chunks():
            hi = lo + m
            if update is not None:
                update(lo, hi, chunk)
            _san.record_dispatch()
            out = histogram_multi_carry(chunk, grad[lo:hi], hess[lo:hi],
                                        chunk_mask(lo, hi), slot[lo:hi], 0, acc,
                                        finalize=hi == n)
            tally["chunks"] += 1
        tally["passes"] += 1
        return out

    def best_for(hist, g, h, c, depth, parent_out) -> BestSplit:
        s = find_best_split(hist, g, h, c, nbpf, mbpf, params, parent_output=parent_out,
                            categorical_mask=cmask, feature_contri=contri,
                            feature_mask=feature_mask, monotone_constraints=None,
                            out_lo=None, out_hi=None, rng_key=None,
                            depth=depth.float(), cegb_feature_penalty=None)
        if max_depth > 0:  # reference: the max_depth check of BeforeFindBestSplit
            s = s._replace(gain=torch.where(depth >= max_depth, KMIN_SCORE, s.gain))
        return s

    def first(v, dtype=torch.float32):
        out = torch.zeros(L, dtype=dtype, device=dev)
        out[0] = v
        return out

    # ---- the root: every in-bag row ----
    hist = torch.zeros((L + 1, 3, f, num_bins), dtype=torch.float32, device=dev)
    hist0 = sweep(lambda lo, hi: row_mask[lo:hi])  # (1, 3, F, B)
    hist[0] = hist0[0]
    g0, h0, c0 = torch.sum(hist0[0, :, 0, :], dim=1)  # totals from feature 0
    leaf_out = first(leaf_output(g0, h0, params))
    leaf_lo = torch.full((L,), float("-inf"), device=dev)
    leaf_hi = torch.full((L,), float("inf"), device=dev)
    best = _empty_best(L, num_bins, dev)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    _set_best(best, zero, best_for(hist0, g0[None], h0[None], c0[None], zero,
                                   leaf_out[:1]))
    leaf_id = torch.zeros(n, dtype=torch.int32, device=dev)
    leaf_sum_g, leaf_sum_h, leaf_count = first(g0), first(h0), first(c0)
    leaf_depth = torch.zeros(L, dtype=torch.int64, device=dev)
    leaf_parent = torch.full((L,), -1, dtype=torch.int64, device=dev)
    leaf_side = torch.zeros(L, dtype=torch.int64, device=dev)
    nlc = torch.ones((), dtype=torch.int64, device=dev)
    tree = empty_tree(L, num_bins, dev)
    sides = torch.arange(2, dtype=torch.int64, device=dev)

    for _ in range(L - 1):
        # the one read a split: whether any leaf still has a split (the
        # strict grower's later steps are masked no-ops from here on)
        if not bool(_san.sync_pull(best.gain.max() > eps)):
            break
        _san.record_dispatch()
        best_leaf = torch.argmax(best.gain)
        s = BestSplit(*[at(a, best_leaf) for a in best])
        bl = best_leaf.reshape(1)
        node, new_leaf = nlc - 1, nlc
        pair = torch.stack([best_leaf, new_leaf])
        feat = s.feature.long()
        mb = mbpf.index_select(0, feat.reshape(1))
        left_smaller = s.left_count <= s.right_count
        small_leaf = torch.where(left_smaller, best_leaf, new_leaf)

        def update(lo, hi, chunk):
            # ---- partition: the chunk's elementwise leaf-id update ----
            split_chunk(leaf_id, chunk, lo, hi, s, feat, mb, best_leaf, new_leaf,
                        cmask)

        # ---- the smaller child's histogram, the sibling by subtraction ----
        fresh = sweep(lambda lo, hi: row_mask[lo:hi] & (leaf_id[lo:hi] == small_leaf),
                      update)
        left_h, right_h = split_window(hist.index_select(0, bl), fresh,
                                       left_smaller.reshape(1))
        children = torch.cat([left_h, right_h])
        hist.index_copy_(0, pair, children)

        # ---- the node (reference: Tree::Split) and the leaf aggregates ----
        accept = idx == best_leaf
        tree = book_tree(tree, accept, node.expand(L), new_leaf.expand(L),
                         leaf_parent, leaf_side,
                         BestSplit(*[a.expand(L, *a.shape) for a in s]),
                         leaf_out, leaf_sum_h, leaf_count,
                         categorical=cmask is not None)
        parent_out = at(leaf_out, best_leaf)
        out_l = leaf_output_smoothed(s.left_sum_g, s.left_sum_h, s.left_count,
                                     parent_out, params)
        out_r = leaf_output_smoothed(s.right_sum_g, s.right_sum_h, s.right_count,
                                     parent_out, params)
        depth_child = at(leaf_depth, best_leaf) + 1
        g2 = torch.stack([s.left_sum_g, s.right_sum_g])
        h2 = torch.stack([s.left_sum_h, s.right_sum_h])
        c2 = torch.stack([s.left_count, s.right_count])
        out2 = torch.stack([out_l, out_r])
        d2 = depth_child.expand(2)
        leaf_sum_g = _put(leaf_sum_g, pair, g2)
        leaf_sum_h = _put(leaf_sum_h, pair, h2)
        leaf_count = _put(leaf_count, pair, c2)
        leaf_depth = _put(leaf_depth, pair, d2)
        leaf_parent = _put(leaf_parent, pair, node.expand(2))
        leaf_side = _put(leaf_side, pair, sides)
        leaf_out = _put(leaf_out, pair, out2)

        # ---- best splits of the two fresh leaves ----
        bb = best_for(children, g2, h2, c2, d2, out2)
        best = BestSplit(*[_put(o, pair, nw) for o, nw in zip(best, bb)])
        nlc = nlc + 1
        tally["splits"] += 1

    leaf_value = final_leaf_values(leaf_out, leaf_sum_g, leaf_sum_h, leaf_lo,
                                   leaf_hi, params, False, False)
    tree = finish_tree(tree, nlc, leaf_value, leaf_sum_g, leaf_sum_h,
                       leaf_count, leaf_depth)
    return tree, leaf_id, tally
