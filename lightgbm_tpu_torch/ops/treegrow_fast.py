"""Round-batched leaf-wise tree growth.

Counterpart of lightgbm_tpu/ops/treegrow_fast.py: each round splits every
evaluated leaf whose gain clears the bar (best-gain-first, at most
``leaf_tile`` per round, within the num_leaves budget), histograms all new
smaller children in ONE multi-leaf kernel pass (ops/hist_cuda.py), recovers
the bigger siblings by subtraction, and evaluates all fresh leaves with one
batched split search.  Split math, admission order and leaf numbering are
the JAX package's, so on fixtures with separated gains both packages grow
the same trees.

A round is the JAX package's masked fixed-tile round: the admitted splits
are a mask over the leaves, the number of leaves lives on the device, the
histogram pass always runs at ``leaf_tile`` slots, and writes of the slots
and leaves a round does not admit land in spare rows.  So a round reads
nothing back and a round that admits nothing is a bitwise no-op.  The host
drives the rounds with the windowed grower's one-behind protocol
(ops/treegrow_windowed.py::_run_fused_rounds): each round's info vector is
read while the next round runs.  With ``graphs`` (ops/graphs.py; GBDT
passes one on its fused path) each round is one run of the same round
function on static buffers, on the card one CUDA-graph replay.

Supported: numerical and categorical splits, missing values, max_depth,
bagging masks and sample weights, path smoothing, feature_contri, float,
bf16 (``hist_precision``: grad and hess rounded to bfloat16 once a tree,
summed exactly) and int8-quantized histograms (quantize_bins,
stochastic_rounding, quant_renew), and EFB bundles (``efb``: the root and
round passes histogram the bundled matrix and unbundle, int8 histograms
before they are scaled; the partition reads the feature bins).  Monotone,
interaction and CEGB constraints, forced splits, linear trees and per-node
sampling raise ValueError (ROADMAP queue A11b).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import sanitizer as _san
from .graphs import RoundGraphs
from .histogram import histogram_multi, histogram_multi_quantized, unbundle
from .round_cuda import split_window
from .split import BestSplit, SplitParams, find_best_split, leaf_output, leaf_output_smoothed
from .treegrow import (TreeArrays, _empty_best, _put, _set_best, admit,
                       admits_next, book_tree, empty_tree, finish_tree,
                       go_left_of, quantize_gradients, reject_unported)
from .treegrow_windowed import _run_fused_rounds, round_runner

class FState(NamedTuple):
    leaf_id: torch.Tensor  # (N,) i32
    hist: torch.Tensor  # (L + 1, 3, F, B) f32, row L a spare; in place
    best: BestSplit
    leaf_sum_g: torch.Tensor
    leaf_sum_h: torch.Tensor
    leaf_count: torch.Tensor
    leaf_depth: torch.Tensor  # i64
    leaf_parent: torch.Tensor  # i64, -1 at the root
    leaf_side: torch.Tensor  # i64
    num_leaves_cur: torch.Tensor  # 0-d i64
    leaf_out: torch.Tensor
    tree: TreeArrays
    inputs_finite: torch.Tensor  # 0-d bool


class FInputs(NamedTuple):
    """A tree's inputs to its rounds (the static buffers' second part)."""
    grad: torch.Tensor  # f32, or bf16 under hist_precision=bf16
    hess: torch.Tensor
    gq: Optional[torch.Tensor]
    hq: Optional[torch.Tensor]
    quant_scale: Optional[torch.Tensor]
    row_mask: torch.Tensor
    feature_mask: Optional[torch.Tensor]


def predict_leaf_arrays(arrays: TreeArrays, bins: torch.Tensor,
                        missing_bin_per_feature: torch.Tensor,
                        categorical: bool = False) -> torch.Tensor:
    """Leaf index per row for a device tree on binned rows (host analogue:
    Tree::GetLeafIndex).  Children encode leaves as ~leaf.  ``categorical``:
    the tree may hold categorical nodes (their bin-space masks route)."""
    n = bins.shape[0]
    L = arrays.leaf_value.shape[0]
    # a one-leaf tree starts every row at leaf 0 (~(-1)): nothing is read back
    start = torch.where(arrays.num_leaves > 1, 0, -1).to(torch.int64)
    cur = torch.zeros(n, dtype=torch.int64, device=bins.device) + start
    sf = arrays.split_feature.long()
    lc, rc = arrays.left_child.long(), arrays.right_child.long()
    for _ in range(max(L - 1, 1)):
        nd = cur.clamp(0, max(L - 2, 0))
        ft = sf[nd]
        col = bins.gather(1, ft[:, None])[:, 0].to(torch.int32)
        gl = go_left_of(col, missing_bin_per_feature[ft], arrays.default_left[nd],
                        arrays.threshold_bin[nd],
                        *((arrays.is_cat[nd], arrays.cat_mask[nd, col.long()])
                          if categorical else ()))
        cur = torch.where(cur >= 0, torch.where(gl, lc[nd], rc[nd]), cur)
    return (-cur - 1).to(torch.int32)


def _multi_hist(bins, inp: FInputs, leaf_slot, tile: int, num_bins: int,
                quantize_bins: int, hist_precision: str, efb=None) -> torch.Tensor:
    """(N,)-slot -> (tile, 3, F, B) f32: per-slot histograms, one pass (over
    the bundled matrix, then unbundled, with an EFB plan)."""
    src = bins if efb is None else efb[0]
    m = inp.row_mask & (leaf_slot >= 0)
    if quantize_bins:
        hi = histogram_multi_quantized(src, inp.gq, inp.hq, m, leaf_slot, 0,
                                       tile, num_bins)
        return unbundle(hi, efb, num_bins).float() * inp.quant_scale[:, None, None]
    return unbundle(histogram_multi(src, inp.grad, inp.hess, m, leaf_slot, 0, tile,
                                    num_bins, precision=hist_precision), efb, num_bins)


def _f_init(bins, grad, hess, row_mask, sample_weight, feature_mask, nbpf, mbpf,
            *, num_leaves: int, num_bins: int, params: SplitParams,
            quantize_bins: int, stochastic_rounding: bool,
            generator: Optional[torch.Generator], hist_precision: str = "f32",
            categorical_mask=None, feature_contri=None, hist=None, efb=None):
    """Root state: quantize gradients, the root pass, seed best.  ``hist``:
    the (L + 1, 3, F, B) buffer for the histogram state, else a new one;
    ``efb``: the EFB tables.  Returns (state, FInputs, grad_true,
    hess_true)."""
    dev = bins.device
    n, f = bins.shape
    L = num_leaves
    grad = grad.float() * sample_weight
    hess = hess.float() * sample_weight
    grad_true, hess_true = grad, hess
    gq = hq = quant_scale = None
    if quantize_bins:
        gq, hq, grad, hess, quant_scale = quantize_gradients(
            grad, hess, row_mask, quantize_bins, stochastic_rounding, generator)
    elif hist_precision == "bf16":  # rounded once, as the payload is built
        grad, hess = grad.to(torch.bfloat16), hess.to(torch.bfloat16)
    inputs = FInputs(grad, hess, gq, hq, quant_scale, row_mask, feature_mask)
    minus1 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    hist0 = _multi_hist(bins, inputs, torch.where(row_mask, 0, minus1), 1,
                        num_bins, quantize_bins, hist_precision, efb)[0]
    g0, h0, c0 = torch.sum(hist0[:, 0, :], dim=1)  # totals from feature 0
    leaf_out0 = leaf_output(g0, h0, params)
    best = _empty_best(L, num_bins, dev)
    _set_best(best, torch.zeros(1, dtype=torch.int64, device=dev), find_best_split(
        hist0[None], g0[None], h0[None], c0[None], nbpf, mbpf, params,
        feature_mask=feature_mask, parent_output=leaf_out0[None],
        categorical_mask=categorical_mask, feature_contri=feature_contri))

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def first(v):
        out = zeros(L)
        out[0] = v
        return out

    if hist is None:
        hist = zeros((L + 1, 3, f, num_bins))
    else:
        hist.zero_()
    hist[0] = hist0
    state = FState(
        leaf_id=zeros(n, torch.int32), hist=hist, best=best,
        leaf_sum_g=first(g0), leaf_sum_h=first(h0), leaf_count=first(c0),
        leaf_depth=zeros(L, torch.int64),
        leaf_parent=torch.full((L,), -1, dtype=torch.int64, device=dev),
        leaf_side=zeros(L, torch.int64),
        num_leaves_cur=torch.ones((), dtype=torch.int64, device=dev),
        leaf_out=first(leaf_out0), tree=empty_tree(L, num_bins, dev),
        inputs_finite=torch.isfinite(grad_true).all() & torch.isfinite(hess_true).all())
    return state, inputs, grad_true, hess_true


def _round(st: FState, bins, inp: FInputs, nbpf, mbpf, cmask=None, contri=None, *,
           num_leaves: int, num_bins: int, max_depth: int, params: SplitParams,
           leaf_tile: int, quantize_bins: int, hist_precision: str = "f32",
           efb=None):
    """One masked fixed-tile round; returns (state', info) with info =
    [k_acc, 0, 1, 0, finite, k_next] (i32, on the device; the windowed
    round's layout, whose window fields this round has no use for)."""
    L, T = num_leaves, leaf_tile
    dev = bins.device
    s = st.best
    idx = torch.arange(L, dtype=torch.int64, device=dev)
    nlc = st.num_leaves_cur
    drop = -1  # _put's index of the spare slot

    # ---------- phase 1: admit this round's splits ----------
    accept, order_rank, _ = admit(s.gain, st.leaf_depth, nlc, num_leaves=L,
                                  leaf_tile=T, max_depth=max_depth)
    k_acc = accept.sum()
    acc_rank = torch.where(accept, order_rank, L)
    node_of = nlc - 1 + acc_rank  # node slot of each admitted leaf
    right_of = nlc + acc_rank  # leaf id of its right child

    # ---------- row partition: all admitted splits at once ----------
    lid = st.leaf_id.long()
    r_row = torch.where(accept, right_of, -1)[lid]
    feat_row = s.feature.long()[lid]
    col = bins.gather(1, feat_row[:, None])[:, 0].to(torch.int32)
    gl = go_left_of(col, mbpf[feat_row], s.default_left[lid], s.threshold_bin[lid],
                    *((s.is_cat[lid], s.cat_mask[lid, col.long()])
                      if cmask is not None else ()))
    leaf_id = torch.where((r_row >= 0) & ~gl, r_row.to(torch.int32), st.leaf_id)

    # ---------- tree and leaf bookkeeping (left keeps the id) ----------
    tree = book_tree(st.tree, accept, node_of, right_of, st.leaf_parent,
                     st.leaf_side, s, st.leaf_out, st.leaf_sum_h, st.leaf_count,
                     categorical=cmask is not None)
    right_pos = torch.where(accept, right_of, drop)

    def upd(arr, left_val, right_val):
        return _put(torch.where(accept, left_val, arr), right_pos, right_val)

    leaf_sum_g = upd(st.leaf_sum_g, s.left_sum_g, s.right_sum_g)
    leaf_sum_h = upd(st.leaf_sum_h, s.left_sum_h, s.right_sum_h)
    leaf_count = upd(st.leaf_count, s.left_count, s.right_count)
    depth_child = st.leaf_depth + 1
    leaf_depth = upd(st.leaf_depth, depth_child, depth_child)
    leaf_parent = upd(st.leaf_parent, node_of, torch.where(accept, node_of, 0))
    leaf_side = _put(torch.where(accept, 0, st.leaf_side), right_pos, 1)
    leaf_out = upd(
        st.leaf_out,
        leaf_output_smoothed(s.left_sum_g, s.left_sum_h, s.left_count,
                             st.leaf_out, params),
        leaf_output_smoothed(s.right_sum_g, s.right_sum_h, s.right_count,
                             st.leaf_out, params))
    num_leaves_new = nlc + k_acc

    # ---------- phase 2: one pass at the tile for all smaller children ----------
    left_smaller = s.left_count <= s.right_count
    small = torch.where(left_smaller, idx, right_of)
    slot_of_leaf = _put(torch.full((L,), -1, dtype=torch.int64, device=dev),
                        torch.where(accept, small, drop), acc_rank)
    fresh = _multi_hist(bins, inp, slot_of_leaf[leaf_id.long()].to(torch.int32),
                        T, num_bins, quantize_bins, hist_precision, efb)  # (T, 3, F, B)
    # per admission rank: the split leaf (the left child keeps its id), the
    # right child, and which one the pass histogrammed
    pos_r = torch.where(accept, acc_rank, -1)
    minus1 = torch.full((T,), -1, dtype=torch.int64, device=dev)
    slot_left = _put(minus1, pos_r, idx)
    slot_right = _put(minus1, pos_r, right_of)
    active = slot_left >= 0
    sl = slot_left.clamp(0, L - 1)
    sr = slot_right.clamp(0, L - 1)
    small_left = _put(torch.zeros(T, dtype=torch.int32, device=dev), pos_r,
                      left_smaller)
    left_h, right_h = split_window(st.hist.index_select(0, sl), fresh, small_left)
    spare = L  # inactive slots write the spare row
    st.hist.index_copy_(0, torch.where(active, sl, spare), left_h)
    st.hist.index_copy_(0, torch.where(active, sr, spare), right_h)

    # ---------- phase 3: evaluate the fresh leaves ----------
    cand = torch.cat([sl, sr])
    cand_ok = torch.cat([active, active])
    ci = torch.where(cand_ok, cand, 0)
    bb = find_best_split(torch.cat([left_h, right_h]), leaf_sum_g[ci],
                         leaf_sum_h[ci], leaf_count[ci], nbpf, mbpf, params,
                         feature_mask=inp.feature_mask, parent_output=leaf_out[ci],
                         categorical_mask=cmask, feature_contri=contri)
    scatter_pos = torch.where(cand_ok, cand, drop)
    best = BestSplit(*[_put(o, scatter_pos, nw) for o, nw in zip(s, bb)])

    state = FState(
        leaf_id=leaf_id, hist=st.hist, best=best, leaf_sum_g=leaf_sum_g,
        leaf_sum_h=leaf_sum_h, leaf_count=leaf_count, leaf_depth=leaf_depth,
        leaf_parent=leaf_parent, leaf_side=leaf_side,
        num_leaves_cur=num_leaves_new, leaf_out=leaf_out, tree=tree,
        inputs_finite=st.inputs_finite)
    finite = (st.inputs_finite & torch.isfinite(leaf_sum_g).all()
              & torch.isfinite(leaf_sum_h).all() & torch.isfinite(leaf_out).all()
              & ~torch.isnan(best.gain).any())
    k_next = admits_next(best.gain, leaf_depth, num_leaves_new, num_leaves=L,
                         leaf_tile=T, max_depth=max_depth)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    info = torch.stack([k_acc, zero, zero + 1, zero, finite.long(), k_next])
    return state, info.to(torch.int32)


def _f_finalize(st: FState, inp: FInputs, grad_true, hess_true, *,
                params: SplitParams, quant_renew: bool):
    L = st.leaf_out.shape[0]
    if quant_renew:
        # leaf outputs from the TRUE gradients (reference: GBDT::Train ->
        # RenewIntGradTreeOutput): per-leaf sums as a one-feature histogram
        # (bin = leaf id), deterministic like every other kernel sum
        leaf_hist = histogram_multi(
            st.leaf_id.to(torch.int16)[:, None].contiguous(), grad_true,
            hess_true, inp.row_mask, torch.zeros_like(st.leaf_id), 0, 1, L)
        leaf_value = leaf_output(leaf_hist[0, 0, 0], leaf_hist[0, 1, 0], params)
    elif params.path_smooth > 0:
        leaf_value = st.leaf_out  # smoothed at creation
    else:
        leaf_value = leaf_output(st.leaf_sum_g, st.leaf_sum_h, params)
    return finish_tree(st.tree, st.num_leaves_cur, leaf_value, st.leaf_sum_g,
                       st.leaf_sum_h, st.leaf_count, st.leaf_depth), st.leaf_id


def grow_tree_fast(
    bins: torch.Tensor,  # (N, F) int16
    grad: torch.Tensor,  # (N,) f32
    hess: torch.Tensor,
    row_mask: torch.Tensor,  # (N,) bool
    sample_weight: torch.Tensor,  # (N,) f32
    feature_mask: Optional[torch.Tensor],  # (F,) bool
    num_bins_per_feature: torch.Tensor,  # (F,) i32
    missing_bin_per_feature: torch.Tensor,  # (F,) i32
    *,
    num_leaves: int,
    num_bins: int,
    max_depth: int = -1,
    params: SplitParams = SplitParams(),
    leaf_tile: int = 16,
    quantize_bins: int = 0,
    stochastic_rounding: bool = True,
    quant_renew: bool = False,
    generator: Optional[torch.Generator] = None,
    stats: Optional[dict] = None,
    guard_label: str = "",
    graphs: Optional[RoundGraphs] = None,
    hist_precision: str = "f32",
    categorical_mask: Optional[torch.Tensor] = None,  # (F,) bool
    feature_contri: Optional[torch.Tensor] = None,  # (F,) f32
    efb: Optional[tuple] = None,  # Dataset.efb_device_tables()
    **options,
) -> tuple[TreeArrays, torch.Tensor]:
    """Grow one tree in rounds; returns (tree, final leaf_id per row).

    quantize_bins > 0 enables quantized training (reference:
    gradient_discretizer.cpp): gradients/hessians are discretized to int8
    (stochastic rounding draws from ``generator``), histograms accumulate
    exactly in int32, and split evaluation sees the rescaled sums;
    quant_renew recomputes leaf outputs from the true gradients.
    ``graphs``: run every round through that cache's static buffers (one
    CUDA-graph replay a round on the card).  ``stats`` receives the
    utils/sanitizer.py counts of the tree and the driver's retries.
    ``efb``: (bundled (N, F_b) int16, gather, default) of an EFB plan, which
    the histogram passes read; the static buffers of ``graphs`` read them
    where they lie, as they read ``bins``."""
    reject_unported("grow_tree_fast", options)
    if hist_precision not in ("f32", "bf16"):
        raise ValueError(f"hist_precision must be f32 or bf16, got {hist_precision!r}")
    tile = max(1, min(leaf_tile, num_leaves))
    static = dict(num_leaves=num_leaves, num_bins=num_bins, max_depth=max_depth,
                  params=params, leaf_tile=tile, quantize_bins=quantize_bins,
                  hist_precision=hist_precision)
    tables = (categorical_mask, feature_contri)
    fixed = (bins, num_bins_per_feature, missing_bin_per_feature,
             *(t for t in tables if t is not None), *(efb or ()))

    def round_fn(st, inp: FInputs, _W):
        return _round(st, bins, inp, num_bins_per_feature,
                      missing_bin_per_feature, *tables, efb=efb, **static)

    with _san.DispatchCounter() as counter:
        try:
            hist = None if graphs is None or graphs.buffers is None else (
                graphs.buffers[0].hist)
            state, inputs, g_true, h_true = _f_init(
                bins, grad, hess, row_mask, sample_weight, feature_mask,
                num_bins_per_feature, missing_bin_per_feature,
                num_leaves=num_leaves, num_bins=num_bins, params=params,
                quantize_bins=quantize_bins,
                stochastic_rounding=stochastic_rounding, generator=generator,
                hist_precision=hist_precision, categorical_mask=categorical_mask,
                feature_contri=feature_contri, hist=hist, efb=efb)
            state = _run_fused_rounds(
                round_runner(round_fn, state, inputs, fixed,
                             ("rounds",) + tuple(static.items()), graphs),
                state, n_ladder=None, w_first=None, num_leaves=num_leaves,
                stats=stats, guard_label=guard_label)
            tree, leaf_id = _f_finalize(
                state, inputs, g_true, h_true, params=params,
                quant_renew=bool(quant_renew and quantize_bins))
            if graphs is not None:  # the next tree overwrites the buffers
                tree = TreeArrays(*[None if a is None else a.clone() for a in tree])
                leaf_id = leaf_id.clone()
            return tree, leaf_id
        finally:
            if stats is not None:
                stats.update(counter.stats())
