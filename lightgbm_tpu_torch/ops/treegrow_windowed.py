"""Windowed round-batched growth: the wide-regime (Epsilon-class) grower.

Counterpart of lightgbm_tpu/ops/treegrow_windowed.py, single device.  The
rounds grower (ops/treegrow_fast.py) histograms all N rows every round;
this one keeps rows physically grouped by leaf (reference: DataPartition's
[start, count) ranges, src/treelearner/data_partition.hpp) so a round
reads only its small children's rows, the window.

One round (``_round_fused``) is a fixed sequence of device work with no
host read inside it:

* admission, split decisions and segment geometry, as the rounds grower
  admits (best gain first, at most ``leaf_tile`` a round);
* an on-device check that the window fits W, the host's predicted window
  size; a breach makes the round a no-op and reports, so a wrong
  prediction costs a retried round, never a wrong tree;
* either the round megakernel (ops/round_cuda.py: partition, window
  histograms from the row-major bins through the new order, subtraction
  and per-feature split search in one entry point), or the three-pass
  round: the segment partition (ops/partition_cuda.py), the window rows
  gathered into a (W, F) block and histogrammed by the multi-leaf kernel
  (float or int8), subtraction (round_cuda.window_histograms and
  split_window, which the megakernel's plain version shares) and split
  search in torch;
* the bookkeeping, and a 6-scalar info vector [admitted splits, window
  rows, fits W, next-window bound, all finite, splits the next round
  admits].

The host (``_run_fused_rounds``, which the rounds grower shares) launches
round r+1 before it reads round r's info vector, which was copied to pinned
memory behind an event one round earlier, so the device queue never
drains; the next W comes from the bound (``whint``): every split's small
child holds at most half of its leaf, so the top-(tile) halves of the live
leaves' counts bound both next rounds' windows.  A tree ends when a round
reports that the next admits nothing: the round already launched then is a
no-op.  utils/sanitizer.py counts rounds, blocking reads (one a tree: the
maxima of the gradients, checked finite before the first round) and async
resolves, and with ops/graphs.py captures, replays and dispatches.

With ``graphs`` (ops/graphs.py; GBDT passes one when fused_training is on)
each round is one run of the same round function on static buffers: on the
card one CUDA-graph replay, captured once per window rung and training.
The tree's inputs (gradients, quantized lanes and scale, masks, exponent
pair) are copied into the buffers before its first round.

Float histograms use one fixed-point exponent pair per tree, taken from
all N rows (hist_cuda.fixed_shift_tensor: an int32[2] on the device, which
the kernels read when they run), so every window histogram equals bit for
bit what the rounds grower's full-N pass gives for the same rows, and the
megakernel's equals the three-pass round's.

State updates are functional but for the (L + 1, 3, F, B) histogram state,
which is written in place (row L is a spare that takes the writes of
inactive slots).  Trees do not depend on W: it only bounds the window.

Scope: numerical and categorical features (a categorical split routes the
bins of its mask left), missing values, max_depth, bagging masks and
sample weights, feature_contri, float and int8-quantized gradients,
hist_precision=bf16 in the root pass and the three-pass window pass (the
megakernel's window pass sums f32, as the JAX package's does), and EFB
bundles: outside the megakernel's envelope, as in the JAX package, so an
EFB tree takes the three-pass round, reports ``megakernel_excluded``
"efb" and counts a megakernel fallback (utils/sanitizer.py); its root pass
and window pass histogram the bundled (N, F_b) matrix and unbundle, while
the partition and the split's go-left test read the feature bins.
Per-node feature sampling (extra_trees, feature_fraction_bynode: the
tree's uniform table ``rng_key``, indexed by node id as in
ops/treegrow.py) is outside the megakernel's envelope too, as in the JAX
package: it takes the three-pass round and reports "node_rng".

Telemetry (obs/, under the JAX package's names): the round loop records
each resolved round's ``train_window_rows`` and ``train_window_fill``
histograms and ``windowed_round`` span, and each tree's
``train_windowed_rounds_total`` / ``train_windowed_retries_total``, the
``windowed_tree`` event and span; the gate counts
``train_megakernel_trees_total`` and ``megakernel_envelope_fallbacks_total``.
All of it runs on the host loop around the launches (never inside a
captured round, whose body a CUDA graph replays without the host) and
reads only what the loop has read already.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import torch

from ..obs import metrics as _obs
from ..obs import trace as _trace
from ..utils import sanitizer as _san
from ..utils.guards import NonFiniteError
from ..utils.log import log_warning
from .graphs import RoundGraphs, copy_into
from .hist_cuda import fixed_shift_pair, fixed_shift_tensor
from .histogram import histogram_multi, histogram_multi_quantized, unbundle
from .partition import segment_ids
from .partition_cuda import partition_segments
from .round_cuda import round_megakernel, split_window, window_histograms
from .split import (KMIN_SCORE, BestSplit, SplitParams, find_best_split,
                    leaf_output, select_from_feature_best)
from .treegrow import (TreeArrays, _empty_best, _put, _set_best, admit,
                       admits_next, book_tree, empty_tree, go_left_of,
                       quantize_gradients)


class WState(NamedTuple):
    order: torch.Tensor  # (N,) i32: row ids physically grouped by leaf
    leaf_start: torch.Tensor  # (L,) i64: position of each leaf's range
    leaf_cnt: torch.Tensor  # (L,) i64
    leaf_id: torch.Tensor  # (N,) i32: leaf per ROW
    hist: torch.Tensor  # (L + 1, 3, F, B) f32, row L a spare; in place
    best: BestSplit
    leaf_sum_g: torch.Tensor
    leaf_sum_h: torch.Tensor
    leaf_count: torch.Tensor
    leaf_depth: torch.Tensor  # i64
    leaf_parent: torch.Tensor  # i64
    leaf_side: torch.Tensor  # i64
    num_leaves_cur: torch.Tensor  # 0-d i64
    leaf_out: torch.Tensor
    tree: TreeArrays


class WInputs(NamedTuple):
    """A tree's inputs to its rounds (the static buffers' second part)."""
    grad: torch.Tensor
    hess: torch.Tensor
    gq: Optional[torch.Tensor]
    hq: Optional[torch.Tensor]
    quant_scale: Optional[torch.Tensor]
    row_mask: torch.Tensor
    feature_mask: torch.Tensor
    shift: torch.Tensor  # (2,) i32 fixed-point exponents
    rng: Optional[torch.Tensor] = None  # (2L-1, 2, F) node uniforms


INFO = 6  # scalars in a round's info vector


def _ladder(n: int, floor: int = 8192):
    """The W ladder for (n, floor): factor-4 steps to 128k, then factor-2,
    clamped to (and ending at) round_up(n, floor)."""
    cap = -(-n // floor) * floor
    w = floor
    while True:
        yield min(w, cap)
        if w >= cap:
            return
        w *= 4 if w < 131072 else 2


def _window_size(x: int, n: int, floor: int = 8192) -> int:
    """Window size quantization: the first ladder rung covering ``x``."""
    for w in _ladder(n, floor):
        if w >= x:
            break
    return w


def _round_fused(state: WState, bins, grad, hess, gq, hq, quant_scale,
                 row_mask, num_bins_pf, missing_bin_pf, feature_mask, cmask=None,
                 contri=None, *, num_leaves: int, num_bins: int, max_depth: int,
                 params: SplitParams, leaf_tile: int, W: int,
                 quantize_bins: int, megakernel: bool, shift: torch.Tensor,
                 hist_precision: str = "f32", efb=None, rng=None):
    """One whole boosting round; returns (state', info) with info = [k_acc,
    window_total, fits_W, whint, finite, k_next] (i32, on the device).
    ``efb``: the EFB tables (three-pass rounds only): the window pass
    histograms the bundled matrix and unbundles.  ``rng``: the tree's node
    uniforms (three-pass rounds only).  The round is its stages in order
    (round_geometry, the partition, round_rows, the window pass,
    round_finish); ops/treegrow_fleet.py runs the same stages for each of
    its lanes around one lane-mode launch of each kernel."""
    T = leaf_tile
    g = round_geometry(state, bins, missing_bin_pf, cmask, num_leaves=num_leaves,
                       leaf_tile=T, max_depth=max_depth, params=params, W=W)
    i32 = torch.int32
    if megakernel:
        cand_tab = torch.stack([g.leaf_sum_g[g.ci], g.leaf_sum_h[g.ci],
                                g.leaf_count[g.ci], g.leaf_out[g.ci]]).contiguous()
        new_order, left_h, right_h, fbests = round_megakernel(
            bins, state.order, g.go_left, grad, hess, row_mask,
            g.seg_start.to(i32), g.seg_len_eff.to(i32), g.n_left_seg.to(i32),
            g.win_start.to(i32), g.win_cnt.to(i32), g.slot_small_left.to(i32),
            g.parent_hists, cand_tab, num_bins_pf, missing_bin_pf, feature_mask,
            params=params, W=W, shift=shift, categorical_mask=cmask,
            feature_contri=contri)
    else:
        new_order, _ = partition_segments(state.order, g.seg_start.to(i32),
                                          g.seg_len_eff.to(i32), g.go_left)
    rows = round_rows(state, g, new_order, cmask)
    if megakernel:
        return round_finish(state, g, rows, left_h, right_h, num_bins_pf,
                            missing_bin_pf, feature_mask, cmask, contri,
                            num_leaves=num_leaves, num_bins=num_bins,
                            max_depth=max_depth, params=params, leaf_tile=T,
                            fbests=fbests)
    # ---- three-pass: window gather -> multi-leaf pass -> subtraction ----
    win = (new_order, bins if efb is None else efb[0])
    geo = (row_mask, g.win_start, g.win_cnt, W, T, num_bins)
    if quantize_bins:
        fresh_h = unbundle(window_histograms(
            histogram_multi_quantized, *win, (gq, hq), *geo), efb, num_bins
        ).float() * quant_scale[:, None, None]
    else:
        fresh_h = unbundle(window_histograms(
            histogram_multi, *win, (grad, hess), *geo, shift=shift,
            precision=hist_precision), efb, num_bins)
    left_h, right_h = split_window(g.parent_hists, fresh_h, g.slot_small_left)
    return round_finish(state, g, rows, left_h, right_h, num_bins_pf,
                        missing_bin_pf, feature_mask, cmask, contri,
                        num_leaves=num_leaves, num_bins=num_bins,
                        max_depth=max_depth, params=params, leaf_tile=T, rng=rng)


class RoundGeometry(NamedTuple):
    """A round's decisions before its partition (round_geometry)."""
    accept: torch.Tensor
    k_acc: torch.Tensor
    total: torch.Tensor
    ok: torch.Tensor
    live_rk: torch.Tensor
    leaf_of_rank: torch.Tensor
    seg_start: torch.Tensor
    seg_len_eff: torch.Tensor
    seg_id: torch.Tensor
    sid: torch.Tensor
    n_left_seg: torch.Tensor
    go_left: torch.Tensor
    node_of: torch.Tensor
    right_of: torch.Tensor
    leaf_sum_g: torch.Tensor
    leaf_sum_h: torch.Tensor
    leaf_count: torch.Tensor
    leaf_depth: torch.Tensor
    leaf_parent: torch.Tensor
    leaf_side: torch.Tensor
    leaf_out: torch.Tensor
    num_leaves_new: torch.Tensor
    fresh: torch.Tensor
    slot_small_left: torch.Tensor
    leaf_start: torch.Tensor
    leaf_cnt: torch.Tensor
    win_start: torch.Tensor
    win_cnt: torch.Tensor
    active: torch.Tensor
    sl: torch.Tensor
    sr: torch.Tensor
    parent_hists: torch.Tensor
    cand: torch.Tensor
    cand_ok: torch.Tensor
    ci: torch.Tensor


def round_geometry(state: WState, bins, missing_bin_pf, cmask=None, *,
                   num_leaves: int, leaf_tile: int, max_depth: int,
                   params: SplitParams, W: int) -> RoundGeometry:
    """Admission, split decisions, segment and window geometry, the window
    check against W and the order-independent bookkeeping of a round."""
    L, T = num_leaves, leaf_tile
    n, f = bins.shape
    dev = bins.device
    s = state.best
    idx = torch.arange(L, dtype=torch.int64, device=dev)
    nlc = state.num_leaves_cur
    drop = -1  # _put's index of the spare slot

    # ---- admission (the rounds grower's semantics) ----
    accept0, order_rank, srt = admit(s.gain, state.leaf_depth, nlc, num_leaves=L,
                                     leaf_tile=T, max_depth=max_depth)

    # ---- split decisions + segment geometry (pre-partition) ----
    leaf_of_rank = srt[:T]
    live_rk = accept0[leaf_of_rank]
    feats_rk = torch.where(live_rk, s.feature[leaf_of_rank].long(), 0)
    seg_start = torch.where(live_rk, state.leaf_start[leaf_of_rank], 0)
    seg_len = torch.where(live_rk, state.leaf_cnt[leaf_of_rank], 0)
    seg_id = segment_ids(seg_start, seg_len, n).long()  # admission rank
    sid = seg_id.clamp_min(0)
    # each position's bin of its segment's split feature: one gather of the
    # row-major matrix (a contiguous row, one column of it)
    col = bins.view(-1)[state.order.long() * f + feats_rk[sid]].to(torch.int32)
    thr = s.threshold_bin[leaf_of_rank][sid]
    dl = s.default_left[leaf_of_rank][sid]
    mb = missing_bin_pf[feats_rk][sid]
    go_left = go_left_of(col, mb, dl, thr, *(
        (s.is_cat[leaf_of_rank][sid], s.cat_mask[leaf_of_rank][sid, col.long()])
        if cmask is not None else ()))

    # ---- on-device window verification ----
    # segments are contiguous position ranges: differences of one prefix sum
    # (a scatter-add into T slots would serialise on T atomic words)
    cl = torch.cumsum((go_left & (seg_id >= 0)).long(), 0)
    cl = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), cl])
    left_counts = cl[seg_start + seg_len] - cl[seg_start]
    left_small = 2 * left_counts <= seg_len
    win_cnt_rk = torch.where(live_rk, torch.where(left_small, left_counts,
                                                  seg_len - left_counts), 0)
    total = win_cnt_rk.sum()
    ok = total <= W
    accept = accept0 & ok
    live_rk = live_rk & ok
    k_acc = accept.sum()
    acc_rank = torch.where(accept, order_rank, L)
    node_of = nlc - 1 + acc_rank
    right_of = nlc + acc_rank
    seg_id = torch.where(ok, seg_id, -1)
    seg_len_eff = torch.where(ok, seg_len, 0)
    n_left_seg = torch.where(live_rk, left_counts, 0)

    # ---- order-independent bookkeeping ----
    right_pos = torch.where(accept, right_of, drop)

    def upd(arr, left_val, right_val):
        return _put(torch.where(accept, left_val, arr), right_pos, right_val)

    leaf_sum_g = upd(state.leaf_sum_g, s.left_sum_g, s.right_sum_g)
    leaf_sum_h = upd(state.leaf_sum_h, s.left_sum_h, s.right_sum_h)
    leaf_count = upd(state.leaf_count, s.left_count, s.right_count)
    depth_child = state.leaf_depth + 1
    leaf_depth = upd(state.leaf_depth, depth_child, depth_child)
    leaf_parent = upd(state.leaf_parent, node_of, torch.where(accept, node_of, 0))
    leaf_side = _put(torch.where(accept, 0, state.leaf_side), right_pos, 1)
    leaf_out = upd(state.leaf_out, leaf_output(s.left_sum_g, s.left_sum_h, params),
                   leaf_output(s.right_sum_g, s.right_sum_h, params))
    num_leaves_new = nlc + k_acc

    fresh = _put(accept.clone(), right_pos, True)
    pos_r = torch.where(accept, acc_rank, -1)
    minus1 = torch.full((T,), -1, dtype=torch.int64, device=dev)
    slot_left = _put(minus1, pos_r, idx)
    slot_right = _put(minus1, pos_r, right_of)
    slot_small_left = live_rk & left_small  # slot r == admission rank r

    # leaf ranges: the left child keeps the leaf's start
    st_rk = state.leaf_start[leaf_of_rank]
    ct_rk = state.leaf_cnt[leaf_of_rank]
    rp = right_of[leaf_of_rank].clamp(0, L - 1)
    leaf_start = _put(state.leaf_start, torch.where(live_rk, rp, drop),
                      st_rk + n_left_seg)
    leaf_cnt = _put(state.leaf_cnt, torch.where(live_rk, leaf_of_rank, drop),
                    n_left_seg)
    leaf_cnt = _put(leaf_cnt, torch.where(live_rk, rp, drop), ct_rk - n_left_seg)

    # windows: per admission rank, the SMALL child's [start, cnt)
    sm = torch.where(left_small, leaf_of_rank, rp)
    win_start = torch.where(live_rk, leaf_start[sm], 0)
    win_cnt = torch.where(live_rk, leaf_cnt[sm], 0)

    active = slot_left >= 0
    sl = slot_left.clamp(0, L - 1)
    sr = slot_right.clamp(0, L - 1)
    parent_hists = state.hist.index_select(0, sl)  # (T, 3, F, B)
    cand = torch.cat([sl, sr])
    cand_ok = torch.cat([active, active])
    ci = torch.where(cand_ok, cand, 0)
    return RoundGeometry(
        accept=accept, k_acc=k_acc, total=total, ok=ok, live_rk=live_rk,
        leaf_of_rank=leaf_of_rank, seg_start=seg_start, seg_len_eff=seg_len_eff,
        seg_id=seg_id, sid=sid, n_left_seg=n_left_seg, go_left=go_left,
        node_of=node_of, right_of=right_of, leaf_sum_g=leaf_sum_g,
        leaf_sum_h=leaf_sum_h, leaf_count=leaf_count, leaf_depth=leaf_depth,
        leaf_parent=leaf_parent, leaf_side=leaf_side, leaf_out=leaf_out,
        num_leaves_new=num_leaves_new, fresh=fresh, slot_small_left=slot_small_left,
        leaf_start=leaf_start, leaf_cnt=leaf_cnt, win_start=win_start,
        win_cnt=win_cnt, active=active, sl=sl, sr=sr, parent_hists=parent_hists,
        cand=cand, cand_ok=cand_ok, ci=ci)


def round_rows(state: WState, g: RoundGeometry, new_order, cmask=None):
    """After the partition: each row's leaf id, the tree arrays and the
    best splits with the split leaves' cleared.  Returns (new_order,
    leaf_id, tree, best)."""
    n = new_order.shape[0]
    dev = new_order.device
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    sid = g.sid
    # ---- per-row leaf ids (needs the partitioned order) ----
    new_rows = new_order.long()
    lid_pos = state.leaf_id[new_rows]
    in_right = ((g.seg_id >= 0) & g.live_rk[sid]
                & (pos >= g.seg_start[sid] + g.n_left_seg[sid]))
    lid_pos = torch.where(in_right, g.right_of[g.leaf_of_rank][sid].to(torch.int32),
                          lid_pos)
    leaf_id = torch.empty_like(state.leaf_id)
    leaf_id[new_rows] = lid_pos

    # ---- tree arrays ----
    s = state.best
    tree = book_tree(state.tree, g.accept, g.node_of, g.right_of, state.leaf_parent,
                     state.leaf_side, s, state.leaf_out, state.leaf_sum_h,
                     state.leaf_count, categorical=cmask is not None)
    best = s._replace(gain=torch.where(g.fresh, KMIN_SCORE, s.gain))
    return new_order, leaf_id, tree, best


def round_finish(state: WState, g: RoundGeometry, rows, left_h, right_h,
                 num_bins_pf, missing_bin_pf, feature_mask, cmask=None,
                 contri=None, *, num_leaves: int, num_bins: int, max_depth: int,
                 params: SplitParams, leaf_tile: int, fbests=None, rng=None):
    """The children's histograms into the state, their split search (from
    the megakernel's per-feature bests ``fbests``, or in torch), the
    next-window bound and the info vector.  Returns (state', info)."""
    L, T = num_leaves, leaf_tile
    new_order, leaf_id, tree, best = rows
    dev = left_h.device
    idx = torch.arange(L, dtype=torch.int64, device=dev)
    drop = -1
    spare = L  # inactive slots write the spare row
    state.hist.index_copy_(0, torch.where(g.active, g.sl, spare), left_h)
    state.hist.index_copy_(0, torch.where(g.active, g.sr, spare), right_h)

    # ---- fresh-leaf split search ----
    ci, cand_ok = g.ci, g.cand_ok
    pg, ph, pc = g.leaf_sum_g[ci], g.leaf_sum_h[ci], g.leaf_count[ci]
    if fbests is not None:
        bb = select_from_feature_best(
            fbests, pg, ph, pc, num_bins, categorical_mask=cmask,
            cand_hist=None if cmask is None else torch.cat([left_h, right_h]),
            missing_bin_per_feature=missing_bin_pf, params=params)
    else:
        node_ids = g.leaf_parent.clamp_min(0) * 2 + g.leaf_side + 1
        bb = find_best_split(torch.cat([left_h, right_h]), pg, ph, pc,
                             num_bins_pf, missing_bin_pf, params,
                             feature_mask=feature_mask,
                             parent_output=g.leaf_out[ci], categorical_mask=cmask,
                             feature_contri=contri,
                             rng_key=None if rng is None else rng[node_ids[ci]])
    scatter_pos = torch.where(cand_ok, g.cand, drop)
    best = BestSplit(*[_put(o, scatter_pos, nw) for o, nw in zip(best, bb)])

    # ---- next-window bound for the host's ladder ----
    num_leaves_new = g.num_leaves_new
    half_cnt = torch.where(idx < num_leaves_new, g.leaf_cnt // 2, 0)
    k_top = min(T, L)
    top = torch.topk(half_cnt, k_top).values
    budget_next = (L - num_leaves_new).clamp_min(0).clamp_max(T)
    whint = torch.where(torch.arange(k_top, device=dev) < budget_next, top, 0).sum()

    state = WState(
        order=new_order, leaf_start=g.leaf_start, leaf_cnt=g.leaf_cnt,
        leaf_id=leaf_id, hist=state.hist, best=best, leaf_sum_g=g.leaf_sum_g,
        leaf_sum_h=g.leaf_sum_h, leaf_count=g.leaf_count, leaf_depth=g.leaf_depth,
        leaf_parent=g.leaf_parent, leaf_side=g.leaf_side,
        num_leaves_cur=num_leaves_new, leaf_out=g.leaf_out, tree=tree)
    # ---- non-finite guard, in the same info vector ----
    finite = (torch.isfinite(g.leaf_sum_g).all() & torch.isfinite(g.leaf_sum_h).all()
              & torch.isfinite(g.leaf_out).all() & ~torch.isnan(best.gain).any())
    k_next = admits_next(best.gain, g.leaf_depth, num_leaves_new, num_leaves=L,
                         leaf_tile=T, max_depth=max_depth)
    info = torch.stack([g.k_acc, g.total, g.ok.long(), whint, finite.long(),
                        k_next]).to(torch.int32)
    return state, info


def _w_init(bins, grad, hess, row_mask, sample_weight, num_bins_pf,
            missing_bin_pf, feature_mask, *, num_leaves: int, num_bins: int,
            params: SplitParams, quantize_bins: int, stochastic_rounding: bool,
            generator: Optional[torch.Generator], hist_precision: str = "f32",
            categorical_mask=None, feature_contri=None, hist=None, efb=None,
            rng=None, check_finite: bool = True):
    """Root state: quantize gradients, the one full-N pass, seed best.
    ``hist``: the (L + 1, 3, F, B) buffer to hold the histogram state (the
    static one of a graph cache), else a new one; ``efb``: the EFB tables
    (the pass reads the bundled matrix).  ``check_finite``: make the
    tree's blocking read of the gradients' maxima here (a fleet makes one
    for all its lanes).  Returns (state, WInputs, grad_true, hess_true)."""
    n, f = bins.shape
    L = num_leaves
    dev = bins.device
    grad = grad.float() * sample_weight
    hess = hess.float() * sample_weight
    grad_true, hess_true = grad, hess
    gq = hq = quant_scale = None
    if quantize_bins:
        gq, hq, grad, hess, quant_scale = quantize_gradients(
            grad, hess, row_mask, quantize_bins, stochastic_rounding, generator)
    if check_finite:
        fixed_shift_pair(grad, hess)  # the tree's one blocking host read: finite?
    shift = fixed_shift_tensor(grad, hess)
    slot0 = torch.zeros(n, dtype=torch.int32, device=dev)
    src = bins if efb is None else efb[0]
    if quantize_bins:
        hist0 = unbundle(histogram_multi_quantized(src, gq, hq, row_mask, slot0, 0, 1,
                                                    num_bins), efb, num_bins
                          )[0].float() * quant_scale[:, None, None]
    else:
        hist0 = unbundle(histogram_multi(src, grad, hess, row_mask, slot0, 0, 1,
                                          num_bins, shift=shift,
                                          precision=hist_precision), efb, num_bins)[0]
    g0, h0, c0 = torch.sum(hist0[:, 0, :], dim=1)  # totals from feature 0
    leaf_out0 = leaf_output(g0, h0, params)
    best = _empty_best(L, num_bins, dev)
    _set_best(best, torch.zeros(1, dtype=torch.int64, device=dev), find_best_split(
        hist0[None], g0[None], h0[None], c0[None], num_bins_pf, missing_bin_pf,
        params, feature_mask=feature_mask, parent_output=leaf_out0[None],
        categorical_mask=categorical_mask, feature_contri=feature_contri,
        rng_key=None if rng is None else rng[:1]))

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if hist is None:
        hist = zeros((L + 1, 3, f, num_bins))
    else:
        hist.zero_()
    hist[0] = hist0

    def first(v, dtype=torch.float32):
        out = zeros(L, dtype)
        out[0] = v
        return out

    state = WState(
        order=torch.arange(n, dtype=torch.int32, device=dev),
        leaf_start=zeros(L, torch.int64), leaf_cnt=first(n, torch.int64),
        leaf_id=zeros(n, torch.int32), hist=hist, best=best,
        leaf_sum_g=first(g0), leaf_sum_h=first(h0), leaf_count=first(c0),
        leaf_depth=zeros(L, torch.int64),
        leaf_parent=torch.full((L,), -1, dtype=torch.int64, device=dev),
        leaf_side=zeros(L, torch.int64),
        num_leaves_cur=torch.ones((), dtype=torch.int64, device=dev),
        leaf_out=first(leaf_out0), tree=empty_tree(L, num_bins, dev))
    inputs = WInputs(grad, hess, gq, hq, quant_scale, row_mask, feature_mask,
                     shift, rng)
    return state, inputs, grad_true, hess_true


def _w_finalize(state: WState, grad_true, hess_true, row_mask, *,
                params: SplitParams, quant_renew: bool):
    L = state.leaf_out.shape[0]
    if quant_renew:
        # leaf outputs from the TRUE gradients: per-leaf sums as a
        # one-feature histogram (bin = leaf id), as the rounds grower does
        leaf_hist = histogram_multi(
            state.leaf_id.to(torch.int16)[:, None].contiguous(), grad_true,
            hess_true, row_mask, torch.zeros_like(state.leaf_id), 0, 1, L)
        leaf_value = leaf_output(leaf_hist[0, 0, 0], leaf_hist[0, 1, 0], params)
    else:
        leaf_value = leaf_output(state.leaf_sum_g, state.leaf_sum_h, params)
    active = torch.arange(L, device=leaf_value.device) < state.num_leaves_cur
    tree = state.tree._replace(
        num_leaves=state.num_leaves_cur.to(torch.int32),
        leaf_value=torch.where(active, leaf_value, 0.0),
        leaf_weight=torch.where(active, state.leaf_sum_h, 0.0),
        leaf_count=torch.where(active, state.leaf_count, 0.0),
        leaf_sum_g=torch.where(active, state.leaf_sum_g, 0.0),
        leaf_depth=state.leaf_depth.to(torch.int32))
    return tree, state.leaf_id


def round_runner(round_fn, state, inputs, fixed, key, graphs: Optional[RoundGraphs]):
    """The driver's ``round(state, W) -> (state', info)``.  Without
    ``graphs``: ``round_fn(state, inputs, W)``, functional.  With them, the
    tree's state and inputs are loaded into the cache's static buffers and
    each round is ``graphs.run``: ``round_fn`` on the buffers, its new state
    and info copied back into them (on the card one replay of the graph
    captured for ``key + (W,)``).  ``fixed`` are the tensors the rounds read
    where they lie."""
    if graphs is None:
        return lambda st, W: round_fn(st, inputs, W)
    info = torch.zeros(INFO, dtype=torch.int32, device=inputs.grad.device)
    buffers = graphs.load((state, inputs, info), fixed)

    def run(_, W):
        def body(b):
            st, inp, out = b
            new, new_info = round_fn(st, inp, W)
            copy_into(st, new)
            out.copy_(new_info)

        graphs.run(key + (W,), body)
        return buffers[0], buffers[2]

    return run


def _run_fused_rounds(round_fn, state, *, n_ladder: Optional[int],
                      w_first: Optional[int], num_leaves: int,
                      stats: Optional[dict], guard_label: str, floor: int = 8192):
    """The round protocol: W predicted from the bound, each round's info
    read one round behind, a breach retried at a corrected W, a non-finite
    flag raised as NonFiniteError, and the tree ended when a round reports
    that the next admits nothing (the round in flight then is a no-op).
    ``round_fn(state, W) -> (state', info)`` launches one round without
    reading anything back.  ``n_ladder`` None: the rounds take no window
    (the rounds grower), W stays None."""
    n = n_ladder
    W = w_first
    pending: list = []  # launched rounds whose info is still in flight
    n_leaves = 1
    retries = 0
    windows: list = []  # W of every launched round
    # every productive round admits >= 1 split, reads lag 1 round, plus
    # headroom for retried (skipped) rounds
    max_rounds = 2 * num_leaves + 4
    converged = False
    resolved = 0
    # the windowed grower's telemetry (the rounds grower shares this loop)
    tele = n is not None and _obs.enabled()
    t_open = t_prev = time.perf_counter()
    try:
        while len(windows) < max_rounds:
            _san.record_dispatch()
            state, info_d = round_fn(state, W)
            pending.append(_san.async_pull_start(info_d))
            windows.append(W)
            if len(pending) < 2:
                continue  # pipeline fill: resolve reads one round behind
            k_acc, total, ok, whint, finite, k_next = (
                int(v) for v in _san.async_pull_result(pending.pop(0)))
            resolved += 1
            if tele:
                # the resolve just made is the loop's own read: the span
                # from the previous one is the round that retired between
                w_ran = windows[resolved - 1]
                _obs.histogram("train_window_rows").observe(total)
                _obs.histogram("train_window_fill").observe(total / max(w_ran, 1))
                t_now = time.perf_counter()
                _trace.record_span("windowed_round", t_now - t_prev, round=resolved,
                                   k_acc=k_acc, rows=total, W=w_ran, whint=whint,
                                   first=resolved == 1)
                t_prev = t_now
            if not finite:
                _obs.counter("train_nonfinite_errors_total").inc()
                _obs.event("nonfinite", phase="windowed", round=resolved)
                raise NonFiniteError(
                    f"non-finite gradients/hessians/split stats on the device "
                    f"at round {resolved}{guard_label}: refusing to keep "
                    "boosting on NaNs; check labels, weights and custom "
                    "objective outputs")
            if not ok:
                # the window bound was breached: the device skipped the round;
                # fold the corrected W into the next launch
                retries += 1
                W = _window_size(max(total, 1), n, floor)
                continue
            n_leaves += k_acc
            if k_acc == 0 or k_next == 0:
                converged = True
                break
            if n is not None:
                W = _window_size(max(whint, 1), n, floor)
        # drain the in-flight round so its finite flag is checked too
        while pending:
            info = _san.async_pull_result(pending.pop(0))
            resolved += 1
            if tele:
                t_now = time.perf_counter()
                _trace.record_span("windowed_round", t_now - t_prev, round=resolved,
                                   k_acc=int(info[0]), rows=int(info[1]),
                                   W=windows[resolved - 1], whint=int(info[3]),
                                   first=resolved == 1, drained=True)
                t_prev = t_now
            if not int(info[4]):
                _obs.counter("train_nonfinite_errors_total").inc()
                _obs.event("nonfinite", phase="windowed_drain", round=resolved)
                raise NonFiniteError(
                    f"non-finite gradients/hessians/split stats on the device "
                    f"at round {resolved}{guard_label} (drained "
                    "in-flight round): refusing to finalize a tree grown on NaNs")
    finally:
        pending.clear()
        if stats is not None:
            stats.update(retries=retries, windows=windows)
        if tele:
            rounds = len(windows)
            _obs.counter("train_windowed_rounds_total").inc(rounds)
            _obs.counter("train_windowed_retries_total").inc(retries)
            _obs.event("windowed_tree", rounds=rounds, retries=retries,
                       resolved=resolved)
            _trace.record_span("windowed_tree", time.perf_counter() - t_open,
                               rounds=rounds, retries=retries)
    if not converged:
        log_warning(
            f"round-batched growth exhausted its round budget ({max_rounds} "
            f"rounds, {retries} window retries) before reaching num_leaves="
            f"{num_leaves}; the tree is valid but under-grown")
    return state


def megakernel_mode(on_card: bool, *, quantize_bins: int = 0, efb: bool = False,
                    node_rng: bool = False,
                    mode: Optional[str] = None) -> Tuple[bool, Optional[str]]:
    """The round-megakernel gate: returns (megakernel, exclusion reason).

    ``mode`` (the Booster's ``megakernel`` extra parameter): ``auto`` (the
    default: on wherever the kernels run, i.e. on the card), ``1`` (on; on
    the CPU the megakernel's plain version runs), ``0`` (off).  On the card,
    int8-quantized training is outside the megakernel's envelope: the
    three-pass round sums the int8 values exactly while the megakernel
    would fold the dequantized floats, so it takes the three-pass round and
    the reason ``quantized`` is reported (in the grower's stats).  EFB
    bundles (``efb``) and per-node feature sampling (``node_rng``) are
    outside the envelope wherever the megakernel was asked for, as in the
    JAX package: reasons ``efb`` and ``node_rng``.  Every exclusion counts
    a megakernel fallback (utils/sanitizer.py)."""
    mode = "auto" if mode is None else str(mode).lower()
    if mode in ("0", "off", "false"):
        return False, None
    if mode not in ("auto", "1", "on", "true"):
        raise ValueError(f"megakernel must be auto, 1 or 0, got {mode!r}")
    if not (mode != "auto" or on_card):
        return False, None
    reason = ("efb" if efb else "node_rng" if node_rng
              else "quantized" if quantize_bins and on_card else None)
    if reason is not None:
        _san.record_megakernel_fallback()
        _obs.counter("megakernel_envelope_fallbacks_total").inc()
        _obs.event("megakernel_fallback", reason=reason)
        return False, reason
    return True, None


def grow_tree_windowed(
    bins: torch.Tensor,  # (N, F) int16, row-major
    grad: torch.Tensor,
    hess: torch.Tensor,
    row_mask: torch.Tensor,
    sample_weight: torch.Tensor,
    feature_mask: torch.Tensor,  # (F,) bool
    num_bins_per_feature: torch.Tensor,
    missing_bin_per_feature: torch.Tensor,
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
    megakernel_opt: Optional[str] = None,
    graphs: Optional[RoundGraphs] = None,
    hist_precision: str = "f32",
    categorical_mask: Optional[torch.Tensor] = None,  # (F,) bool
    feature_contri: Optional[torch.Tensor] = None,  # (F,) f32
    efb: Optional[tuple] = None,  # Dataset.efb_device_tables()
    rng_key: Optional[torch.Tensor] = None,  # (2L-1, 2, F) node uniforms
    **options,
) -> tuple[TreeArrays, torch.Tensor]:
    """Grow one tree with windowed rounds; returns (tree, leaf_id per row).
    ``graphs``: run every round through that cache's static buffers (one
    CUDA-graph replay a round on the card), else as eager torch launches.
    ``stats``, when given, receives {rounds, host_syncs, async_resolves,
    captures, replays, dispatches, megakernel_fallbacks, retries, windows,
    megakernel, megakernel_excluded}: the counts of utils/sanitizer.py over
    the whole tree.  ``efb``: an EFB plan's (bundled (N, F_b) int16,
    gather, default), which the root and window passes read (the
    three-pass round: the megakernel excludes it).  ``rng_key``: the
    tree's node uniforms for extra_trees and feature_fraction_bynode (the
    three-pass round too)."""
    if options:
        raise TypeError(f"unexpected options: {sorted(options)}")
    if feature_mask is None:
        feature_mask = torch.ones(bins.shape[1], dtype=torch.bool,
                                  device=bins.device)
    with _san.DispatchCounter() as counter:  # the gate's fallback count too
        mk, excluded = megakernel_mode(bins.is_cuda, quantize_bins=quantize_bins,
                                       efb=efb is not None,
                                       node_rng=rng_key is not None,
                                       mode=megakernel_opt)
        if mk and _obs.enabled():
            _obs.counter("train_megakernel_trees_total").inc()
        tile = max(1, min(leaf_tile, num_leaves))
        static = dict(num_leaves=num_leaves, num_bins=num_bins, max_depth=max_depth,
                      params=params, leaf_tile=tile, quantize_bins=quantize_bins,
                      megakernel=mk, hist_precision=hist_precision)
        tables = (categorical_mask, feature_contri)
        fixed = (bins, num_bins_per_feature, missing_bin_per_feature,
                 *(t for t in tables if t is not None), *(efb or ()))

        def round_fn(st, inp: WInputs, W):
            return _round_fused(
                st, bins, inp.grad, inp.hess, inp.gq, inp.hq, inp.quant_scale,
                inp.row_mask, num_bins_per_feature, missing_bin_per_feature,
                inp.feature_mask, *tables, W=W, shift=inp.shift, efb=efb,
                rng=inp.rng, **static)

        try:
            hist = None if graphs is None or graphs.buffers is None else (
                graphs.buffers[0].hist)
            state, inputs, g_true, h_true = _w_init(
                bins, grad, hess, row_mask, sample_weight, num_bins_per_feature,
                missing_bin_per_feature, feature_mask, num_leaves=num_leaves,
                num_bins=num_bins, params=params, quantize_bins=quantize_bins,
                stochastic_rounding=stochastic_rounding, generator=generator,
                hist_precision=hist_precision, categorical_mask=categorical_mask,
                feature_contri=feature_contri, hist=hist, efb=efb, rng=rng_key)
            n = bins.shape[0]
            # round 1 needs no feedback: a round's window (the small
            # children) can never exceed floor(N/2) rows, whatever it admits
            state = _run_fused_rounds(
                round_runner(round_fn, state, inputs, fixed,
                             ("windowed",) + tuple(static.items()), graphs),
                state, n_ladder=n, w_first=_window_size(max(n // 2, 1), n),
                num_leaves=num_leaves, stats=stats, guard_label=guard_label)
            tree, leaf_id = _w_finalize(
                state, g_true, h_true, inputs.row_mask, params=params,
                quant_renew=bool(quant_renew and quantize_bins))
            if graphs is not None:  # the next tree overwrites the buffers
                tree = TreeArrays(*[None if a is None else a.clone() for a in tree])
                leaf_id = leaf_id.clone()
            return tree, leaf_id
        finally:
            if stats is not None:
                stats.update(counter.stats(), megakernel=mk,
                             megakernel_excluded=excluded)
